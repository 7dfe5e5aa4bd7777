"""Feature front-end golden tests against OpenCV semantics.

SURVEY.md §7 stage 3 requires golden-testing the Harris/Sobel kernels
against the OpenCV behavior the reference relies on (border modes matter:
REFLECT_101, src/viso.cpp:1010).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.config import DetectorConfig
from libviso_tpu.ops import (
    detect_and_describe,
    detect_harris_binned,
    extract_descriptors,
    harris_response,
    sobel_derivatives,
)

cv2 = pytest.importorskip("cv2")


def make_image(rng, h=96, w=200):
    return rng.integers(0, 256, size=(h, w)).astype(np.uint8)


def test_sobel3_matches_opencv(rng):
    img = make_image(rng)
    ours = np.asarray(sobel_derivatives(jnp.asarray(img, jnp.float32),
                                        ksize=3, dx=True))
    ref = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3,
                    borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(ours, ref, atol=1e-3)


def test_sobel5_matches_opencv(rng):
    img = make_image(rng)
    ours = np.asarray(sobel_derivatives(jnp.asarray(img, jnp.float32),
                                        ksize=5, dx=False))
    ref = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=5,
                    borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(ours, ref, atol=1e-2)


def test_harris_matches_opencv(rng):
    img = make_image(rng)
    ours = np.asarray(harris_response(jnp.asarray(img, jnp.float32),
                                      block_size=3, aperture=5, k=0.04))
    ref = cv2.cornerHarris(img, blockSize=3, ksize=5, k=0.04)
    np.testing.assert_allclose(ours, ref, atol=2e-7)


def numpy_binned_topk(resp, cfg):
    """Mirror of the reference detector loop (src/viso.cpp:947-974)."""
    H, W = resp.shape
    sy, sx = H // cfg.nbiny, W // cfg.nbinx
    out = []
    for by in range(cfg.nbiny):
        for bx in range(cfg.nbinx):
            block = np.abs(resp[by * sy:(by + 1) * sy, bx * sx:(bx + 1) * sx])
            vals = block.reshape(-1)
            keep = min(cfg.corners_per_bin, vals.size)
            sel = np.argsort(vals)[::-1][:keep]
            sel = [s for s in sel if vals[s] > 0]
            out.append(np.sort(vals[sel])[::-1])
    return out


def test_detect_binned_topk_values(rng):
    img = make_image(rng, h=100, w=240)
    cfg = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)
    kp = detect_harris_binned(jnp.asarray(img, jnp.float32), cfg)
    resp = cv2.cornerHarris(img, 3, 5, 0.04)
    expected_bins = numpy_binned_topk(resp, cfg)

    xy = np.asarray(kp.xy)
    vals = np.asarray(kp.response)
    valid = np.asarray(kp.valid)
    k = cfg.corners_per_bin
    nb = cfg.nbinx * cfg.nbiny
    got = vals[: nb * k].reshape(nb, k)
    gvalid = valid[: nb * k].reshape(nb, k)
    for b in range(nb):
        g = np.sort(got[b][gvalid[b]])[::-1]
        e = expected_bins[b][: len(g) + 1]
        np.testing.assert_allclose(g, e[: len(g)], rtol=1e-4)
        assert len(e) == len(g)  # same number of kept corners

    # keypoint coordinates carry their own response value
    sy, sx = img.shape[0] // cfg.nbiny, img.shape[1] // cfg.nbinx
    for i in np.nonzero(valid)[0][:50]:
        x, y = int(xy[i, 0]), int(xy[i, 1])
        np.testing.assert_allclose(abs(resp[y, x]), vals[i], rtol=1e-4)


def test_detector_budget_and_padding(rng):
    img = make_image(rng, h=96, w=192)
    cfg = DetectorConfig(max_features=120, nbinx=6, nbiny=4, num_slots=128)
    kp = detect_harris_binned(jnp.asarray(img, jnp.float32), cfg)
    assert kp.xy.shape == (128, 2)
    assert int(jnp.sum(kp.valid)) <= 120
    # padded slots are zeroed
    assert not bool(jnp.any(kp.valid[120:]))
    np.testing.assert_array_equal(np.asarray(kp.xy[120:]), 0)


def numpy_descriptor(img, xy, radius):
    """Mirror of MyFeatureExtractor::computeImpl (src/viso.cpp:1004-1024),
    with the >=0 bounds fix documented in ops/features.py."""
    sob = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3,
                    borderType=cv2.BORDER_REFLECT_101)
    H, W = img.shape
    d = np.zeros((len(xy), (2 * radius + 1) ** 2), np.float32)
    for k, (x, y) in enumerate(xy):
        col = 0
        for i in range(-radius, radius + 1):
            for j in range(-radius, radius + 1):
                yy, xx = int(y) + i, int(x) + j
                if 0 <= yy < H and 0 <= xx < W:
                    d[k, col] = sob[yy, xx]
                col += 1
    return d


def test_descriptors_match_reference_semantics(rng):
    img = make_image(rng, h=64, w=128)
    cfg = DetectorConfig(max_features=40, nbinx=4, nbiny=2, num_slots=128,
                         descriptor_radius=5)
    kp, desc = detect_and_describe(jnp.asarray(img, jnp.float32), cfg)
    valid = np.asarray(kp.valid)
    xy = np.asarray(kp.xy)[valid]
    expected = numpy_descriptor(img, xy, cfg.descriptor_radius)
    got = np.asarray(desc)[valid]
    np.testing.assert_allclose(got[:, :121], expected, atol=1e-3)
    # zero tail pad and zero invalid rows
    np.testing.assert_array_equal(got[:, 121:], 0)
    np.testing.assert_array_equal(np.asarray(desc)[~valid], 0)


def test_descriptor_border_keypoint(rng):
    img = make_image(rng, h=32, w=64)
    cfg = DetectorConfig(descriptor_radius=5, num_slots=128)
    from libviso_tpu.ops.features import Keypoints
    xy = jnp.zeros((128, 2), jnp.float32)
    xy = xy.at[0].set(jnp.array([0.0, 0.0]))       # corner pixel
    xy = xy.at[1].set(jnp.array([63.0, 31.0]))     # far corner
    valid = jnp.zeros(128, bool).at[0].set(True).at[1].set(True)
    kp = Keypoints(xy=xy, response=jnp.ones(128), valid=valid)
    desc = extract_descriptors(jnp.asarray(img, jnp.float32), kp, cfg)
    expected = numpy_descriptor(img, [(0, 0), (63, 31)], 5)
    np.testing.assert_allclose(np.asarray(desc)[:2, :121], expected, atol=1e-3)


def test_descriptor_gather_onehot_bitexact():
    """The one-hot patch gather must be bitwise identical to the flat
    XLA gather (each output has exactly one nonzero contribution; bf16x3
    passes reconstruct f32 exactly)."""
    import dataclasses

    from libviso_tpu.config import DetectorConfig
    from libviso_tpu.ops.features import detect_harris_binned, \
        extract_descriptors

    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.integers(0, 256, (160, 416)), jnp.float32)
    cfg = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)
    kp = detect_harris_binned(img, cfg)
    d_onehot = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="onehot"))
    d_take = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="take"))
    np.testing.assert_array_equal(np.asarray(d_onehot), np.asarray(d_take))


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("gather", ["onehot", "onehot_i8"])
def test_descriptor_gather_banded_bitexact(gather, subpixel):
    """The bin-banded gather (binned_layout=True — both one-hot modes)
    must be bitwise identical to the flat gather on real detector
    output, including subpixel-refined keypoints (whose <=0.5 px drift
    the banded windows' +-1 apron covers) and invalid/pad slots."""
    import dataclasses

    from libviso_tpu.config import DetectorConfig
    from libviso_tpu.ops.features import detect_harris_binned, \
        extract_descriptors

    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.integers(0, 256, (160, 416)), jnp.float32)
    # num_slots > n: exercises the zero-padded tail slots too
    cfg = DetectorConfig(max_features=231, nbinx=7, nbiny=3, num_slots=256,
                         descriptor_gather=gather)
    kp = detect_harris_binned(img, cfg)
    if subpixel:
        from libviso_tpu.ops.features import harris_response
        from libviso_tpu.ops.pyramid import subpixel_refine

        resp = harris_response(img, cfg.block_size, cfg.aperture,
                               cfg.harris_k)
        kp = subpixel_refine(resp, kp)
    d_banded = extract_descriptors(img, kp, cfg, binned_layout=True)
    d_take = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="take"))
    np.testing.assert_array_equal(np.asarray(d_banded), np.asarray(d_take))


def test_unsharp_mask_matches_scipy(rng):
    """unsharp_mask must reproduce the host formula it was tuned under
    (scipy gaussian_filter, truncate=4 — docs/realism.md measured the
    blur-sigma-3 recovery with this operator).  Border: REFLECT_101,
    the repo-wide convention (= scipy "mirror"; the tuning run used
    scipy's edge-repeating default, which differs only inside the
    radius-wide border band)."""
    from scipy.ndimage import gaussian_filter

    from libviso_tpu.ops.features import unsharp_mask

    img = rng.integers(0, 256, (96, 256)).astype(np.float32)
    for sigma, amount in ((1.5, 2.0), (3.0, 4.0)):
        want = np.clip(
            img + amount * (img - gaussian_filter(img, sigma,
                                                  mode="mirror")),
            0.0, 255.0)
        got = np.asarray(unsharp_mask(jnp.asarray(img), sigma, amount))
        np.testing.assert_allclose(got, want, atol=2e-3)


def test_nms_dedups_adjacent_maxima(rng):
    """nms_radius > 0 keeps only local maxima of |response|: a strong
    corner's neighboring pixels must no longer occupy budget slots
    (default 0 = reference parity, raw nth_element winners,
    src/viso.cpp:961-963)."""
    from libviso_tpu.config import DetectorConfig
    from libviso_tpu.ops.features import detect_harris_binned

    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    base = DetectorConfig(max_features=96, nbinx=4, nbiny=2,
                          num_slots=128)
    kp0 = detect_harris_binned(img, base)
    kp1 = detect_harris_binned(
        img, DetectorConfig(max_features=96, nbinx=4, nbiny=2,
                            num_slots=128, nms_radius=2))

    def min_pair_dist(kp):
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min()

    # NMS spreads corners: no two survivors within the radius
    assert min_pair_dist(kp1) > 2.0
    # without NMS adjacent duplicates exist on noise imagery
    assert min_pair_dist(kp0) <= 1.5
    # every NMS survivor is also a raw-response corner (same detector,
    # subset semantics)
    r1 = np.asarray(kp1.response)[np.asarray(kp1.valid)]
    assert (r1 > 0).all()


def test_topk_iterative_bitexact_vs_lax_topk(rng):
    """The iterative (argmax+mask) top-k must be BIT-identical to
    ``lax.top_k`` — values AND indices, including ties (both rules keep
    the lowest index first) — since detect_harris_binned auto-selects it
    for the default corner budget (k=10 <= _TOPK_ITERATIVE_MAX_K)."""
    import jax

    from libviso_tpu.ops.features import _topk_iterative

    # random rows + tie-heavy rows (quantized values force equal entries)
    a = rng.standard_normal((40, 513)).astype(np.float32)
    a[10:20] = np.round(a[10:20] * 2) / 2          # many exact ties
    a[20] = 0.0                                    # all-equal row
    a[21, :5] = np.float32(np.inf)                 # +inf ties
    for k in (1, 3, 10, 16):
        v_ref, i_ref = jax.lax.top_k(jnp.asarray(a), k)
        v_it, i_it = jax.jit(_topk_iterative, static_argnums=1)(
            jnp.asarray(a), k)
        np.testing.assert_array_equal(np.asarray(v_ref), np.asarray(v_it))
        np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_it))


def test_detect_binned_iterative_topk_default_path(rng):
    """detect_harris_binned output is identical whether the per-bin top-k
    runs through the iterative path (default budget) or lax.top_k
    (forced via a large corners_per_bin threshold)."""
    from libviso_tpu.ops import features as F

    img = make_image(rng, h=100, w=240)
    cfg = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)
    assert cfg.corners_per_bin <= F._TOPK_ITERATIVE_MAX_K
    kp_it = detect_harris_binned(jnp.asarray(img, jnp.float32), cfg)

    orig = F._TOPK_ITERATIVE_MAX_K
    try:
        F._TOPK_ITERATIVE_MAX_K = 0  # force the lax.top_k path
        kp_lax = detect_harris_binned(jnp.asarray(img, jnp.float32), cfg)
    finally:
        F._TOPK_ITERATIVE_MAX_K = orig

    np.testing.assert_array_equal(np.asarray(kp_it.xy), np.asarray(kp_lax.xy))
    np.testing.assert_array_equal(np.asarray(kp_it.response),
                                  np.asarray(kp_lax.response))
    np.testing.assert_array_equal(np.asarray(kp_it.valid),
                                  np.asarray(kp_lax.valid))


def test_descriptor_gather_onehot_i8_bitexact():
    """The int8 patch gather must be bitwise identical to the flat
    gather for integer-valued images (ksize-3 Sobel of [0,255] integers
    lies in [-1020,1020]; the 16*hi+lo int8 split reconstructs it
    exactly in int32), and detect_and_describe must produce identical
    output for uint8 and f32 copies of the same image (the round-3
    auto-upgrade to i8 is retired — banding made f32-HIGH faster — but
    the dtype-insensitivity contract stands)."""
    import dataclasses

    from libviso_tpu.ops.features import (detect_and_describe,
                                          detect_harris_binned,
                                          extract_descriptors)

    rng = np.random.default_rng(11)
    img_u8 = rng.integers(0, 256, (160, 416), dtype=np.uint8)
    img = jnp.asarray(img_u8, jnp.float32)
    cfg = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)
    kp = detect_harris_binned(img, cfg)
    d_i8 = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="onehot_i8"))
    d_take = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="take"))
    np.testing.assert_array_equal(np.asarray(d_i8), np.asarray(d_take))

    # extreme values: saturated-black/white blocks exercise the +-1020
    # Sobel extremes and the hi/lo split boundaries
    blocky = np.zeros((96, 256), np.uint8)
    blocky[:, ::2] = 255
    blocky[40:60, 100:140] = rng.integers(0, 256, (20, 40))
    img2 = jnp.asarray(blocky, jnp.float32)
    kp2 = detect_harris_binned(img2, cfg)
    a = extract_descriptors(
        img2, kp2, dataclasses.replace(cfg, descriptor_gather="onehot_i8"))
    b = extract_descriptors(
        img2, kp2, dataclasses.replace(cfg, descriptor_gather="take"))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # auto-selection: uint8 input and f32 input produce identical output
    kp_a, d_a = detect_and_describe(jnp.asarray(img_u8), cfg)
    kp_b, d_b = detect_and_describe(img, cfg)
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))
    np.testing.assert_array_equal(np.asarray(kp_a.xy), np.asarray(kp_b.xy))

    # fractional preprocessing (sharpening) must NOT auto-upgrade:
    # integrality is broken, so the f32-exact onehot path must be kept
    cfg_sharp = dataclasses.replace(cfg, sharpen_sigma=3.0)
    kp_c, d_c = detect_and_describe(jnp.asarray(img_u8), cfg_sharp)
    kp_d, d_d = detect_and_describe(img, cfg_sharp)
    np.testing.assert_array_equal(np.asarray(d_c), np.asarray(d_d))


def test_onehot_i8_not_selected_for_wide_integers():
    """ADVICE r3 (medium): the int8 split is exact only for 8-bit
    sources — uint16 Sobel values overflow hi=round(p/16) past int8 and
    would wrap silently.  detect_and_describe must NOT auto-upgrade for
    integer dtypes wider than uint8; descriptors must match the exact
    f32 path bitwise."""
    import dataclasses

    from libviso_tpu.ops.features import detect_and_describe

    rng = np.random.default_rng(5)
    img16 = rng.integers(0, 65536, (96, 256), dtype=np.uint16)
    cfg = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)
    kp_a, d_a = detect_and_describe(jnp.asarray(img16), cfg)
    kp_b, d_b = detect_and_describe(
        jnp.asarray(img16), dataclasses.replace(cfg,
                                                descriptor_gather="take"))
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))
    np.testing.assert_array_equal(np.asarray(kp_a.xy), np.asarray(kp_b.xy))


def test_onehot_i8_config_rejects_fractional_preprocessing():
    """Hand-written configs combining onehot_i8 with sharpening or
    pyramid levels must be rejected at construction (ADVICE r3 low):
    both produce fractional pixels the int8 split would silently round."""
    import pytest

    with pytest.raises(ValueError, match="onehot_i8"):
        DetectorConfig(descriptor_gather="onehot_i8", sharpen_sigma=2.0)
    with pytest.raises(ValueError, match="onehot_i8"):
        DetectorConfig(descriptor_gather="onehot_i8", pyramid_levels=2)
    DetectorConfig(descriptor_gather="onehot_i8")  # plain form is fine
