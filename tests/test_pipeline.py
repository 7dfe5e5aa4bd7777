"""End-to-end stereo VO on a synthetic ground-truth sequence.

The moving-camera generalization of the reference's synthetic-roundtrip
oracle (test/test.cpp:51-114): render landmarks through a known trajectory,
run the full image pipeline, and require the recovered trajectory to track
ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.config import (
    DetectorConfig,
    PipelineConfig,
    RansacConfig,
)
from libviso_tpu.pipeline import run_stereo_sequence
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.utils.metrics import ate_rmse, rpe_errors


def small_config():
    # Reduced budgets keep the CPU test fast while exercising every stage.
    return PipelineConfig(
        detector=DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                                num_slots=512),
        ransac=RansacConfig(num_hypotheses=32, gn_iters=50),
    )


@pytest.fixture(scope="module")
def synthetic_run():
    seq = generate_sequence(num_frames=8, num_points=500, seed=3,
                            width=416, height=160, speed=0.7)
    result = run_stereo_sequence(seq.frames, seq.P1, seq.P2, small_config(),
                                 seed=0)
    return seq, result


def test_pipeline_recovers_trajectory(synthetic_run):
    seq, result = synthetic_run
    # every frame after the first should solve
    assert result.frame_ok[1:].all(), result.stats
    ate = ate_rmse(result.poses, seq.gt_poses)
    # ~5m driven; sub-decimeter tracking expected on clean synthetic data
    assert ate < 0.1, (ate, result.stats)


def test_pipeline_motion_vectors(synthetic_run):
    seq, result = synthetic_run
    # landmarks render at integer pixels (no subpixel), so ~0.5px
    # quantization bounds per-frame accuracy at a few cm
    np.testing.assert_allclose(result.motions[1:], seq.gt_motions[1:],
                               atol=0.05)


def test_pipeline_rpe(synthetic_run):
    seq, result = synthetic_run
    terr, rerr = rpe_errors(result.poses, seq.gt_poses)
    assert terr.mean() < 0.05
    assert rerr.mean() < 0.01


def test_pipeline_stats_sane(synthetic_run):
    seq, result = synthetic_run
    for s in result.stats[1:]:
        assert s["num_kp1"] > 100
        assert s["num_lr"] > 50
        assert s["num_circle"] >= 10
        assert s["num_inliers"] >= 6


def test_first_frame_is_identity(synthetic_run):
    seq, result = synthetic_run
    np.testing.assert_allclose(result.poses[0], np.eye(4), atol=1e-6)
    assert not result.frame_ok[0]


@pytest.mark.slow
def test_l2_metric_trajectory_close_to_l1():
    """config.py claims the matmul l2 metric yields near-identical match sets;
    back it with a trajectory-level check."""
    seq = generate_sequence(num_frames=8, num_points=400, width=256,
                            height=128, f=200.0, seed=9)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256),
        ransac=RansacConfig(num_hypotheses=16, gn_iters=20),
    )
    r1 = run_stereo_sequence(seq.frames, seq.P1, seq.P2,
                             cfg.with_metric("l1"), seed=0)
    r2 = run_stereo_sequence(seq.frames, seq.P1, seq.P2,
                             cfg.with_metric("l2"), seed=0)
    assert r2.frame_ok[1:].all()
    a1 = ate_rmse(r1.poses, seq.gt_poses)
    a2 = ate_rmse(r2.poses, seq.gt_poses)
    # both metrics must land in the same accuracy regime
    assert a2 < max(2.5 * a1, 0.05), (a1, a2)


def test_chunked_streaming_bit_identical():
    """build_frame_chunk (K frames per dispatch) IS the per-frame step
    scanned — outputs and carried state must be bitwise identical to K
    separate step calls.  This is the evidence gate for bench.py's
    chunked-streaming default."""
    import jax

    from libviso_tpu.config import Calib
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.pipeline import build_frame_chunk, build_frame_step
    from libviso_tpu.pipeline.stereo import empty_state

    seq = generate_sequence(num_frames=8, num_points=400, width=256,
                            height=128, f=200.0, seed=5)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256),
        ransac=RansacConfig(num_hypotheses=16, gn_iters=20),
    ).with_metric("l2")
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = F_from_P_host(seq.P1, seq.P2)
    key = jax.random.PRNGKey(0)

    frames = [(jnp.asarray(l.astype(np.uint8)),
               jnp.asarray(r.astype(np.uint8))) for l, r in seq.frames]

    step = jax.jit(build_frame_step(calib, F, cfg))
    st_ref = empty_state(cfg)
    ref_outs = []
    for t in range(8):
        st_ref, out = step(st_ref, frames[t][0], frames[t][1],
                           jax.random.fold_in(key, t))
        ref_outs.append(out)

    chunk = 4
    cstep = jax.jit(build_frame_chunk(calib, F, cfg, chunk))
    st = empty_state(cfg)
    chunk_outs = []
    for g in range(2):
        lefts = jnp.stack([frames[g * chunk + i][0] for i in range(chunk)])
        rights = jnp.stack([frames[g * chunk + i][1] for i in range(chunk)])
        keys = jnp.stack([jax.random.fold_in(key, g * chunk + i)
                          for i in range(chunk)])
        st, outs = cstep(st, lefts, rights, keys)
        chunk_outs.append(outs)

    # final carried state: bitwise equal
    for a, b in zip(jax.tree_util.tree_leaves(st_ref),
                    jax.tree_util.tree_leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # every per-frame output: bitwise equal
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *chunk_outs)
    for t in range(8):
        for a, b in zip(jax.tree_util.tree_leaves(ref_outs[t]),
                        jax.tree_util.tree_leaves(
                            jax.tree_util.tree_map(lambda x: x[t], stacked))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_driver_chunked_matches_per_frame():
    """run_stereo_sequence(chunk=4) — grouped dispatch plus a 3-frame tail
    — reproduces the per-frame driver's motions/oks/stats exactly."""
    seq = generate_sequence(num_frames=7, num_points=400, width=256,
                            height=128, f=200.0, seed=6)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256),
        ransac=RansacConfig(num_hypotheses=16, gn_iters=20),
    )
    r1 = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0)
    r4 = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0,
                             chunk=4)
    np.testing.assert_array_equal(r1.motions, r4.motions)
    np.testing.assert_array_equal(r1.frame_ok, r4.frame_ok)
    np.testing.assert_array_equal(r1.poses, r4.poses)
    assert r1.stats == r4.stats
