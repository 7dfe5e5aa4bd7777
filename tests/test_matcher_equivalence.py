"""Trajectory-equivalence battery: matmul ``l2`` matcher vs reference ``l1``.

The ``l2`` descriptor metric is one matrix product per problem (matmul
identity) where the reference-parity ``l1`` path is a broadcast-reduce,
but round 1 shipped it off-by-default with one loose 2.5x ATE bound.
This battery is the evidence gate for flipping the default: >=12
sequences spanning seeds, sensor-noise levels, landmark densities, low-
texture and repetitive-texture regimes, and exposure drift. Every
sequence must stay within 2x / 4 cm of its l1 twin (the single-sequence
ATE ratio is itself noisy: measured spread across seeds is 0.4x-2.1x
with both signs, so a tighter per-sequence bound would flake on seed
noise rather than detect metric differences), and the BATTERY-WIDE
aggregates carry the tight equivalence claim: median and geometric-mean
ATE ratio within 15% of 1, l2 winning a nontrivial share outright, and
every frame of every regime solving under both metrics.

The metrics genuinely differ per-match (L1 and L2 nearest neighbors
disagree on a few percent of slots), so equivalence is statistical at the
TRAJECTORY level — exactly the level the framework's output contract
(poses) cares about.  Reference metric: NORM_L1, src/viso.cpp:989-992.
"""

import numpy as np
import pytest

from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.pipeline.stereo import run_stereo_sequence
from libviso_tpu.synthetic import Imaging, generate_sequence
from libviso_tpu.utils.metrics import ate_rmse, rpe_errors

# One image/slot geometry for the whole battery: a single compile per
# metric serves every regime (the scenes vary, the graphs don't).
SHAPE = dict(width=416, height=160, num_frames=8, patch=9,
             subpixel_render=True, pattern_smooth=1.0)

CFG = PipelineConfig(
    detector=DetectorConfig(max_features=360, nbinx=10, nbiny=4,
                            num_slots=384, subpixel=True),
    ransac=RansacConfig(num_hypotheses=32),
).with_metric("l1")   # explicit: l1 is the reference baseline under test

# regime name -> (generate_sequence overrides, seed)
BATTERY = {
    "seed0": (dict(num_points=400), 0),
    "seed1": (dict(num_points=400), 1),
    "seed2": (dict(num_points=400), 2),
    "seed3": (dict(num_points=400), 3),
    "noise3-a": (dict(num_points=400, imaging=Imaging(noise_sigma=3.0)), 4),
    "noise3-b": (dict(num_points=400, imaging=Imaging(noise_sigma=3.0)), 5),
    "noise6": (dict(num_points=400, imaging=Imaging(noise_sigma=6.0)), 6),
    "sparse": (dict(num_points=160), 7),
    "dense": (dict(num_points=800), 8),
    "low-texture": (dict(num_points=400, pattern_smooth=1.6), 9),
    "repetitive": (dict(num_points=400, num_patterns=16), 10),
    "exposure": (dict(num_points=400,
                      imaging=Imaging(exposure_drift=0.10,
                                      lr_gain_mismatch=0.05)), 11),
    "quantized": (dict(num_points=400,
                       imaging=Imaging(quantize=True, noise_sigma=2.0)), 12),
}


@pytest.fixture(scope="module")
def battery_results():
    """Run every regime under both metrics once; tests assert on slices."""
    out = {}
    cfg_l2 = CFG.with_metric("l2")
    cfg_q8 = CFG.with_metric("l2q8")
    for name, (kw, seed) in BATTERY.items():
        shape = dict(SHAPE)
        shape.update(kw)
        seq = generate_sequence(seed=seed + 40, **shape)
        r1 = run_stereo_sequence(seq.frames, seq.P1, seq.P2, CFG, seed=0)
        r2 = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg_l2, seed=0)
        rq = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg_q8, seed=0)
        out[name] = (seq, r1, r2, rq)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", list(BATTERY))
def test_l2_matches_l1_trajectory(battery_results, name):
    seq, r1, r2, _ = battery_results[name]
    assert r1.frame_ok[1:].all(), (name, "l1 failed frames")
    assert r2.frame_ok[1:].all(), (name, "l2 failed frames")
    a1 = ate_rmse(r1.poses, seq.gt_poses)
    a2 = ate_rmse(r2.poses, seq.gt_poses)
    # per-sequence: same accuracy regime.  Relative 2x plus a 5 cm
    # absolute slack — the measured seed-noise spread of the single-
    # sequence ratio is 0.4x-2.1x in both directions with ~5 cm ATE
    # scatter, so a tighter bound would flake on noise rather than
    # detect metric differences; the aggregate test below carries the
    # tight claim.
    assert a2 <= 2.0 * a1 + 0.05, (name, a1, a2)
    t1, _ = rpe_errors(r1.poses, seq.gt_poses)
    t2, _ = rpe_errors(r2.poses, seq.gt_poses)
    assert t2.mean() <= 2.0 * t1.mean() + 0.01, (name, t1.mean(),
                                                 t2.mean())


@pytest.mark.slow
def test_l2_battery_aggregate(battery_results):
    """Across the battery the two metrics must be statistically
    indistinguishable: median and geometric-mean ATE ratio within 15% of
    1, and l2 must win outright on a nontrivial share (sign test — a
    metric that consistently lost would fail even with a median near
    1)."""
    ratios = []
    for name, (seq, r1, r2, _) in battery_results.items():
        a1 = ate_rmse(r1.poses, seq.gt_poses)
        a2 = ate_rmse(r2.poses, seq.gt_poses)
        ratios.append(a2 / max(a1, 1e-9))
    ratios = np.asarray(ratios)
    med = float(np.median(ratios))
    gmean = float(np.exp(np.mean(np.log(ratios))))
    assert med <= 1.15, (med, sorted(np.round(ratios, 2)))
    assert gmean <= 1.15, (gmean, sorted(np.round(ratios, 2)))
    assert (ratios < 1.0).sum() >= len(ratios) // 4, ratios


def test_l2q8_distances_within_quantization_noise(rng):
    """int8-quantized distances agree with exact l2 to the analytic
    quantization bound over realistic descriptor magnitudes."""
    from libviso_tpu.ops.matching import descriptor_distances

    import jax.numpy as jnp

    d1 = jnp.asarray(rng.uniform(-1000, 1000, (64, 128)), jnp.float32)
    d2 = jnp.asarray(rng.uniform(-1000, 1000, (96, 128)), jnp.float32)
    exact = np.asarray(descriptor_distances(d1, d2, metric="l2"))
    quant = np.asarray(descriptor_distances(d1, d2, metric="l2q8"))
    # per-dim quant err <= 4 -> distance err bound ~ sqrt(D)*4
    assert np.max(np.abs(exact - quant)) < np.sqrt(128) * 4.0 + 1.0


@pytest.mark.slow
def test_l2q8_trajectory_matches_l2():
    """One representative sequence: the quantized mode lands in the same
    accuracy regime as exact l2 (the full battery gates the l2-vs-l1
    flip; l2q8 is an opt-in speed mode, PARITY-neutral vs l2)."""
    shape = dict(SHAPE)
    shape.update(num_points=400)
    seq = generate_sequence(seed=41, **shape)
    r2 = run_stereo_sequence(seq.frames, seq.P1, seq.P2,
                             CFG.with_metric("l2"), seed=0)
    rq = run_stereo_sequence(seq.frames, seq.P1, seq.P2,
                             CFG.with_metric("l2q8"), seed=0)
    assert rq.frame_ok[1:].all()
    a2 = ate_rmse(r2.poses, seq.gt_poses)
    aq = ate_rmse(rq.poses, seq.gt_poses)
    assert aq <= 2.0 * a2 + 0.05, (a2, aq)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(BATTERY))
def test_l2q8_matches_l2_trajectory(battery_results, name):
    """Same per-regime gate for the int8 mode vs its parent l2: the
    evidence that would let a future round flip the default on a speed
    measurement alone."""
    seq, _, r2, rq = battery_results[name]
    assert rq.frame_ok[1:].all(), (name, "l2q8 failed frames")
    a2 = ate_rmse(r2.poses, seq.gt_poses)
    aq = ate_rmse(rq.poses, seq.gt_poses)
    assert aq <= 2.0 * a2 + 0.05, (name, a2, aq)


@pytest.mark.slow
def test_l2q8_battery_aggregate(battery_results):
    ratios = []
    for name, (seq, _, r2, rq) in battery_results.items():
        a2 = ate_rmse(r2.poses, seq.gt_poses)
        aq = ate_rmse(rq.poses, seq.gt_poses)
        ratios.append(aq / max(a2, 1e-9))
    ratios = np.asarray(ratios)
    assert float(np.median(ratios)) <= 1.15, sorted(np.round(ratios, 2))
    assert float(np.exp(np.mean(np.log(ratios)))) <= 1.15, (
        sorted(np.round(ratios, 2)))
