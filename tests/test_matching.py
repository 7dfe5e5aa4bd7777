"""Matcher + circle-filter tests against a NumPy mirror of the reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.config import MatchConfig
from libviso_tpu.geometry.mvg import sampson_distance
from libviso_tpu.ops.circle import circle_filter
from libviso_tpu.ops.features import Keypoints
from libviso_tpu.ops.matching import match_descriptors


def random_keypoints(rng, n, n_valid, w=400, h=120, dim=128):
    xy = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
    valid = np.arange(n) < n_valid
    xy[~valid] = 0
    desc = rng.normal(size=(n, dim)).astype(np.float32) * 10
    desc[~valid] = 0
    desc[:, 121:] = 0
    kp = Keypoints(xy=jnp.asarray(xy), response=jnp.ones(n),
                   valid=jnp.asarray(valid))
    return kp, jnp.asarray(desc)


def numpy_match(kp1, d1, kp2, d2, cfg, F=None):
    """Scalar mirror of match_desc (src/viso.cpp:668-726), no neighbor cap.

    Hard-codes the reference L1 metric: callers pin metric='l1' (the
    engine default is the matmul l2 mode since round 2).
    """
    xy1, xy2 = np.asarray(kp1.xy), np.asarray(kp2.xy)
    v1, v2 = np.asarray(kp1.valid), np.asarray(kp2.valid)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    N1 = len(xy1)
    idx = np.full(N1, -1, np.int32)
    for i in range(N1):
        if not v1[i]:
            continue
        best_d1, best_d2, best = np.inf, np.inf, -1
        for j in range(len(xy2)):
            if not v2[j]:
                continue
            if np.abs(xy1[i] - xy2[j]).sum() >= cfg.radius:
                continue
            if cfg.use_epipolar:
                s = float(sampson_distance(jnp.asarray(F),
                                           jnp.asarray(xy1[i]),
                                           jnp.asarray(xy2[j])))
                if not np.isfinite(s) or s > cfg.sampson_thresh:
                    continue
            d = np.abs(d1[i] - d2[j]).sum()
            if d < best_d1:
                best_d2, best_d1, best = best_d1, d, j
            elif d < best_d2:
                best_d2 = d
        if best >= 0:
            if cfg.use_ratio and not (best_d1 < best_d2 * cfg.ratio):
                continue
            idx[i] = best
    return idx


def test_match_plain(rng):
    kp1, d1 = random_keypoints(rng, 128, 100)
    kp2, d2 = random_keypoints(rng, 128, 90)
    cfg = MatchConfig(radius=80.0, metric="l1")
    out = match_descriptors(kp1, d1, kp2, d2, cfg)
    expected = numpy_match(kp1, d1, kp2, d2, cfg)
    np.testing.assert_array_equal(np.asarray(out.idx), expected)
    assert not bool(jnp.any(out.valid[100:]))


def test_match_ratio_test(rng):
    kp1, d1 = random_keypoints(rng, 128, 110)
    kp2, d2 = random_keypoints(rng, 128, 110)
    # near-duplicate descriptors to exercise the ratio rejection
    d2 = d2.at[1].set(d2[0] * 1.0001)
    cfg = MatchConfig(radius=500.0, use_ratio=True, ratio=0.9,
                      metric="l1")
    out = match_descriptors(kp1, d1, kp2, d2, cfg)
    expected = numpy_match(kp1, d1, kp2, d2, cfg)
    np.testing.assert_array_equal(np.asarray(out.idx), expected)


@pytest.mark.slow
def test_match_epipolar_gate(rng):
    # rectified-pair F: matches must be near-horizontal
    F = jnp.array([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    kp1, d1 = random_keypoints(rng, 128, 128)
    kp2, d2 = random_keypoints(rng, 128, 128)
    cfg = MatchConfig(radius=200.0, use_epipolar=True, sampson_thresh=1.0,
                      metric="l1")
    out = match_descriptors(kp1, d1, kp2, d2, cfg, F=F)
    expected = numpy_match(kp1, d1, kp2, d2, cfg, F=F)
    np.testing.assert_array_equal(np.asarray(out.idx), expected)
    # all surviving matches satisfy the vertical-disparity gate
    m = np.asarray(out.valid)
    if m.any():
        dy = np.abs(np.asarray(kp1.xy)[m, 1]
                    - np.asarray(kp2.xy)[np.asarray(out.idx)[m], 1])
        assert (dy <= np.sqrt(2.0) + 1e-3).all()


def test_match_identical_descriptors_self_match(rng):
    kp1, d1 = random_keypoints(rng, 128, 64)
    out = match_descriptors(kp1, d1, kp1, d1, MatchConfig(radius=80.0, metric="l1"))
    got = np.asarray(out.idx[:64])
    np.testing.assert_array_equal(got, np.arange(64))


def numpy_circle(match_lr, match_lr_prev, match11, match22):
    """Mirror of match_circle's quadruple loop (src/viso.cpp:206-243)."""
    ok = np.zeros(len(match_lr), bool)
    for l, r in enumerate(match_lr):
        if r < 0:
            continue
        lp = match11[l]
        if lp < 0:
            continue
        rp = match_lr_prev[lp]
        if rp < 0:
            continue
        if 0 <= r < len(match22) and match22[r] == rp:
            ok[l] = True
    return ok


def test_circle_filter_matches_mirror(rng):
    N = 64
    def rand_match():
        m = rng.integers(-1, N, size=N).astype(np.int32)
        return m
    for _ in range(5):
        lr, lrp, m11, m22 = (rand_match() for _ in range(4))
        res = circle_filter(jnp.asarray(lr), jnp.asarray(lrp),
                            jnp.asarray(m11), jnp.asarray(m22))
        expected = numpy_circle(lr, lrp, m11, m22)
        np.testing.assert_array_equal(np.asarray(res.valid), expected)
        assert int(res.count) == expected.sum()


def test_circle_filter_perfect_tracking():
    # identity matches everywhere -> every slot circles
    N = 32
    ident = jnp.arange(N, dtype=jnp.int32)
    res = circle_filter(ident, ident, ident, ident)
    assert int(res.count) == N
    np.testing.assert_array_equal(np.asarray(res.left_prev), np.arange(N))


def test_match_frame_triple_bit_equal(rng):
    """Fused 3-problem matcher == three separate match_descriptors calls."""
    import jax.numpy as jnp

    from libviso_tpu.config import MatchConfig
    from libviso_tpu.ops.features import Keypoints
    from libviso_tpu.ops.matching import match_descriptors, match_frame_triple

    def mk(n, d):
        return (
            Keypoints(
                xy=jnp.asarray(rng.uniform(0, [300, 100], (n, 2)), jnp.float32),
                response=jnp.asarray(rng.random(n), jnp.float32),
                valid=jnp.asarray(rng.random(n) > 0.1),
            ),
            jnp.asarray(rng.standard_normal((n, d)), jnp.float32),
        )

    n, d = 64, 32
    kp1, d1 = mk(n, d)
    kp2, d2 = mk(n, d)
    kp1p, d1p = mk(n, d)
    kp2p, d2p = mk(n, d)
    F = jnp.asarray(rng.standard_normal((3, 3)), jnp.float32)
    stereo = MatchConfig.stereo()
    temporal = MatchConfig.temporal()

    got = match_frame_triple(kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p,
                             stereo, temporal, F)
    ref = (
        match_descriptors(kp1, d1, kp2, d2, stereo, F=F),
        match_descriptors(kp1, d1, kp1p, d1p, temporal),
        match_descriptors(kp2, d2, kp2p, d2p, temporal),
    )
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g.idx), np.asarray(r.idx))
        np.testing.assert_array_equal(np.asarray(g.valid),
                                      np.asarray(r.valid))
        np.testing.assert_allclose(np.asarray(g.dist), np.asarray(r.dist),
                                   rtol=0, atol=0)


def test_banded_matcher_equals_dense_on_detector_output():
    """Round 4: the strip-banded matcher (match_problem_batch with a
    detector layout) must reproduce the dense path on REAL binned
    detector output — same match indices, validity, and distances.
    Candidate coverage is exact by construction (every pair the L1
    position gate admits lies within the band).  Distances agree only
    to f32 ULP (the banded BATCHED matmul accumulates differently from
    the dense 2-D matmul), so discrete decisions are asserted exactly
    and distances to relative tolerance — the same contract as vmap
    batching (tests/test_multistream.py)."""
    import dataclasses

    import jax.numpy as jnp

    from libviso_tpu.config import DetectorConfig, PipelineConfig
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.ops.features import detect_and_describe
    from libviso_tpu.pipeline.stereo import match_layout
    from libviso_tpu.ops.matching import match_frame_triple
    from libviso_tpu.synthetic import generate_sequence

    seq = generate_sequence(num_frames=2, num_points=600, seed=9,
                            width=416, height=160)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=462, nbinx=11, nbiny=3,
                                num_slots=512))
    F = jnp.asarray(F_from_P_host(seq.P1, seq.P2), jnp.float32)
    feats = {}
    for t in range(2):
        for v in range(2):
            kp, d = detect_and_describe(
                jnp.asarray(seq.frames[t][v]), cfg.detector)
            feats[(t, v)] = (kp, d)
    (kp1, d1), (kp2, d2) = feats[(1, 0)], feats[(1, 1)]
    (kp1p, d1p), (kp2p, d2p) = feats[(0, 0)], feats[(0, 1)]
    # banding is opt-in (MatchConfig.banded)
    cfg = dataclasses.replace(
        cfg, stereo_match=dataclasses.replace(cfg.stereo_match,
                                              banded=True))
    layout = match_layout(cfg, 416)
    assert layout is not None
    banded = match_frame_triple(kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p,
                                cfg.stereo_match, cfg.temporal_match, F,
                                layout=layout, image_width=416)
    dense = match_frame_triple(kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p,
                               cfg.stereo_match, cfg.temporal_match, F)
    for b, m in zip(banded, dense):
        np.testing.assert_array_equal(np.asarray(b.valid),
                                      np.asarray(m.valid))
        np.testing.assert_array_equal(np.asarray(b.idx), np.asarray(m.idx))
        np.testing.assert_allclose(np.asarray(b.dist),
                                   np.asarray(m.dist), rtol=1e-4,
                                   atol=0.5)
    # real matches exist (the comparison is not vacuous)
    assert int(np.asarray(banded[0].valid).sum()) > 100

    # the default (banded=False) keeps the dense path end to end
    assert match_layout(PipelineConfig(), 416) is None


def test_l1_distance_matches_numpy_at_full_width():
    """The plain L1 matcher at the frame step's width: 1280 x 1280 slots of
    128-padded descriptors.  Integer-valued descriptors (uint8 Sobel) keep
    every partial sum exact in f32, so the result is exact."""
    import jax

    from libviso_tpu.ops.matching import _l1_desc_dist_xla

    rng = np.random.default_rng(11)
    d1 = rng.integers(-1020, 1021, (1280, 128)).astype(np.float32)
    d2 = rng.integers(-1020, 1021, (1280, 128)).astype(np.float32)
    got = np.asarray(jax.jit(_l1_desc_dist_xla)(d1, d2))
    want = np.concatenate([
        np.abs(d1[i:i + 64, None, :].astype(np.int64)
               - d2[None, :, :].astype(np.int64)).sum(-1)
        for i in range(0, 1280, 64)])
    np.testing.assert_array_equal(got, want.astype(np.float32))
