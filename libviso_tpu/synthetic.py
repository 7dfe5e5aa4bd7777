"""Synthetic stereo-sequence generator with ground-truth trajectory.

Rendering a textured landmark field through a known camera trajectory gives
an end-to-end oracle for the full image pipeline (detector -> descriptors ->
matching -> circle -> RANSAC/GN), the moving-camera generalization of the
reference's disabled synthetic-roundtrip test (test/test.cpp:51-114).  Also
the benchmark workload when no KITTI data is on disk (BASELINE.md).

Each landmark renders as a small fixed random pattern ("texture patch")
stamped at its projected pixel location; the pattern is constant across
frames and views so Sobel-patch descriptors match, and its sharp edges give
strong Harris responses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from libviso_tpu.geometry.se3 import pose_vector_to_matrix


def _pose_matrix_np(tr):
    """(..., 6) motion vectors -> (..., 4, 4) transforms (tr2mat layout,
    src/viso.cpp:109-133).  Pure numpy: host-side scene generation must
    not round-trip through the device (a jax call here would compile a
    program for trivial 4x4 products, see synthetic_world.py)."""
    tr = np.asarray(tr, np.float64)
    rx, ry, rz = tr[..., 0], tr[..., 1], tr[..., 2]
    sx, cx = np.sin(rx), np.cos(rx)
    sy, cy = np.sin(ry), np.cos(ry)
    sz, cz = np.sin(rz), np.cos(rz)
    out = np.zeros(tr.shape[:-1] + (4, 4))
    out[..., 0, 0] = cy * cz
    out[..., 0, 1] = -cy * sz
    out[..., 0, 2] = sy
    out[..., 1, 0] = sx * sy * cz + cx * sz
    out[..., 1, 1] = -sx * sy * sz + cx * cz
    out[..., 1, 2] = -sx * cy
    out[..., 2, 0] = -cx * sy * cz + sx * sz
    out[..., 2, 1] = cx * sy * sz + sx * cz
    out[..., 2, 2] = cx * cy
    out[..., :3, 3] = tr[..., 3:6]
    out[..., 3, 3] = 1.0
    return out


@dataclasses.dataclass(frozen=True)
class Imaging:
    """Post-render imaging/scene perturbation model (VERDICT r1 next #2).

    The clean renderer is an idealized oracle; real sequences (the
    reference's operating domain, src/kitti.cpp:79-118) add exposure
    variation, sensor noise, optical blur, and independently moving
    occluders.  This model applies those effects AFTER geometry-true
    rendering, so ground-truth poses stay exact while the image evidence
    degrades realistically.  All randomness comes from a stream separate
    from the scene RNG: `generate_sequence(seed=s)` renders bit-identical
    geometry with and without perturbations.

    Pipeline (per frame, in order): occluders -> blur -> gain/bias ->
    sensor noise -> clip [0, 255] -> optional uint8 quantization.
    """

    # Per-frame multiplicative exposure random walk: log-gain steps drawn
    # N(0, exposure_drift).  ~0.05 is a gentle auto-exposure hunt; 0.15 is
    # aggressive (sun in/out of clouds).
    exposure_drift: float = 0.0
    # Left-vs-right gain mismatch: each frame the RIGHT view's log-gain is
    # offset by N(0, lr_gain_mismatch) on top of the shared exposure —
    # unbalanced stereo sensors, the worst case for L/R matching.
    lr_gain_mismatch: float = 0.0
    # Additive per-frame bias (black-level) random walk, DN units.
    bias_drift: float = 0.0
    # Additive white Gaussian sensor noise, DN stddev (KITTI-ish ~2-4).
    noise_sigma: float = 0.0
    # Gaussian optical blur sigma in pixels (defocus / motion smear).
    blur_sigma: float = 0.0
    # Independently moving textured rectangles painted over the scene in
    # both views at a fixed near-object disparity.  They occlude landmarks
    # AND sprout corners whose temporal motion violates ego-motion — the
    # synthetic stand-in for dynamic objects (cars, pedestrians) that
    # RANSAC must reject.
    num_occluders: int = 0
    occluder_size: int = 28
    # Occluder lateral speed, px/frame (drawn U(-v, v) per occluder).
    occluder_speed: float = 6.0
    # Quantize to the uint8 grid (real sensors do; the clean oracle keeps
    # float to isolate detector-precision tests from quantization).
    quantize: bool = False
    # Overexposure: constant multiplicative gain pushing highlights past
    # full well — the [0,255] clip then flattens them into textureless
    # saturated regions where corners vanish (clipped highlights,
    # VERDICT r3 #7).  1.0 = nominal; 2-4 = heavy sun/snow blowout.
    overexposure_gain: float = 1.0
    # Rolling shutter row-time skew (VERDICT r3 #7): the bottom image
    # row is exposed ``rs_fraction`` of one frame time later than the
    # top row, so each row sees the camera advanced by
    # rs_fraction * (row/H) of the NEXT frame's motion.  Applied at
    # RENDER time (per-landmark re-projection in the sprite oracle,
    # band-interpolated poses in the world renderer) so the geometry is
    # genuinely skewed, not warped after the fact; gt_poses remain the
    # start-of-readout poses (the skew is exactly the error source
    # being measured).  Typical automotive CMOS at KITTI-like rates:
    # ~0.3-0.6; 0 = global shutter.
    rs_fraction: float = 0.0


def _gaussian_blur(img, sigma):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma=sigma, mode="nearest")


class _OccluderField:
    """A set of textured rectangles with per-sequence constant velocity."""

    def __init__(self, rng, n, size, speed, width, height):
        self.size = size
        self.tex = rng.integers(30, 226, size=(n, size, size)
                                ).astype(np.float32)
        self.pos0 = np.stack([rng.uniform(0, width, n),
                              rng.uniform(0, height, n)], axis=-1)
        ang = rng.uniform(0, 2 * np.pi, n)
        spd = rng.uniform(0.3 * speed, speed, n)
        self.vel = np.stack([np.cos(ang) * spd, 0.15 * np.sin(ang) * spd],
                            axis=-1)
        # near-object disparity in px (between the closest landmarks and
        # the camera): right-view copy shifts left by this amount
        self.disp = rng.uniform(20.0, 45.0, n)

    def paint(self, im1, im2, k):
        h, w = im1.shape
        for i in range(len(self.tex)):
            x = (self.pos0[i, 0] + k * self.vel[i, 0]) % (w + self.size)
            y = (self.pos0[i, 1] + k * self.vel[i, 1]) % h
            _stamp(im1, int(round(x)), int(round(y)), self.tex[i])
            _stamp(im2, int(round(x - self.disp[i])), int(round(y)),
                   self.tex[i])


@dataclasses.dataclass
class SyntheticSequence:
    frames: List[Tuple[np.ndarray, np.ndarray]]  # (left, right) per frame
    gt_poses: np.ndarray       # (T, 4, 4) camera-to-world (frame 0 = I)
    gt_motions: np.ndarray     # (T, 6) prev->current motion vectors
    P1: np.ndarray             # (3, 4)
    P2: np.ndarray             # (3, 4)
    # per frame: (num_points, 4) columns [ul, vl, ur, vis] — exact float
    # left/right projections + visibility, the oracle for detector
    # localization tests (vr == vl on rectified pairs)
    gt_projections: List[np.ndarray] = None


def kitti_projections(f=718.856, cu=607.1928, cv=185.2157, base=0.5371657,
                      width=1241, height=376):
    P1 = np.array([[f, 0, cu, 0], [0, f, cv, 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[0, 3] = -f * base
    return P1, P2


def _stamp(img, x, y, patch):
    """Add a pattern patch centered at integer (x, y), clipped to bounds."""
    h, w = img.shape
    p = patch.shape[0]
    r = p // 2
    y0, y1 = y - r, y - r + p
    x0, x1 = x - r, x - r + p
    sy0, sx0 = max(0, -y0), max(0, -x0)
    y0, x0 = max(0, y0), max(0, x0)
    y1, x1 = min(h, y1), min(w, x1)
    if y1 <= y0 or x1 <= x0:
        return
    img[y0:y1, x0:x1] = patch[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]


def _stamp_bilinear(img, xf, yf, patch):
    """Stamp a patch at a *fractional* center by bilinear splatting —
    landmarks then sit at true subpixel positions, which is what the
    subpixel-refinement path (BASELINE config 3) is meant to recover."""
    xi, yi = int(np.floor(xf)), int(np.floor(yf))
    ax, ay = xf - xi, yf - yi
    shifted = np.zeros((patch.shape[0] + 1, patch.shape[1] + 1),
                       patch.dtype)
    shifted[:-1, :-1] += (1 - ay) * (1 - ax) * patch
    shifted[:-1, 1:] += (1 - ay) * ax * patch
    shifted[1:, :-1] += ay * (1 - ax) * patch
    shifted[1:, 1:] += ay * ax * patch
    h, w = img.shape
    p = shifted.shape[0]
    r = patch.shape[0] // 2
    y0, x0 = yi - r, xi - r
    y1, x1 = y0 + p, x0 + p
    sy0, sx0 = max(0, -y0), max(0, -x0)
    y0c, x0c = max(0, y0), max(0, x0)
    y1c, x1c = min(h, y1), min(w, x1)
    if y1c <= y0c or x1c <= x0c:
        return
    # composite with max: at integral positions the splat's zero-padded
    # last row/column would otherwise OVERWRITE the noise background with
    # 0, stamping an artificial high-contrast L-border the integer-render
    # _stamp does not produce (it would confound subpixel-vs-integer
    # oracle comparisons with spurious Harris responses)
    dst = img[y0c:y1c, x0c:x1c]
    np.maximum(dst, shifted[sy0:sy0 + (y1c - y0c),
                            sx0:sx0 + (x1c - x0c)], out=dst)


def generate_sequence(num_frames=12, num_points=900, seed=0,
                      width=620, height=188, speed=0.8,
                      yaw_rate=0.004, patch=7,
                      f=360.0, base=0.54,
                      subpixel_render=False,
                      pattern_smooth=0.0,
                      trajectory=None,
                      imaging: Imaging | None = None,
                      num_patterns=0,
                      pattern_type="noise",
                      field_margin=(30.0, 4.0, 30.0)) -> SyntheticSequence:
    """Render a forward-driving stereo sequence over a random landmark field.

    Args:
      num_frames: sequence length.
      num_points: landmarks (spread over a corridor the camera drives into).
      speed: forward translation per frame [m].
      yaw_rate: per-frame yaw increment [rad] (gentle curve).
      patch: landmark texture size in pixels (odd).
      pattern_smooth: Gaussian sigma (px) applied to the random texture
        patches.  Raw patterns are white noise — all their energy at
        Nyquist — so any subpixel resample decorrelates them, which no
        real image does (optics + sampling band-limit real texture).
        ~1.0 with ``subpixel_render=True`` is the realistic regime:
        descriptors stay stable across subpixel phases and the detector's
        quadratic refinement can actually recover the fractional
        position.  0 keeps the legacy sharp patterns.
      trajectory: optional (num_frames, 6) per-frame camera steps in the
        previous camera frame (overrides speed/yaw_rate — e.g. a closed
        circle for loop-closure tests); landmarks then scatter over the
        trajectory's bounding region instead of the forward corridor.
      imaging: optional `Imaging` perturbation model applied after
        rendering (exposure drift, sensor noise, blur, occluders, ...).
        Drawn from a SEPARATE rng stream: the same ``seed`` renders
        bit-identical geometry with and without perturbations.  Note
        `gt_projections` describes the pre-occlusion scene.
      num_patterns: if > 0, draw only this many DISTINCT texture patches
        and cycle them across landmarks — repetitive texture (building
        facades, road markings) that produces aliased descriptor matches
        the gates must reject.  0 = every landmark unique (legacy).
      field_margin: (x, y, z) expansion of the landmark box around a
        CUSTOM trajectory's bounding region.  Narrow margins concentrate
        the field near the path — e.g. opposite-heading revisit tests
        need landmark density inside the small frustum-intersection
        region, not spread over a 60 m apron.  Ignored for the default
        forward corridor.
    """
    rng = np.random.default_rng(seed)
    cu, cv = width / 2.0, height / 2.0
    P1 = np.array([[f, 0, cu, 0], [0, f, cv, 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[0, 3] = -f * base

    # RNG consumption order is part of the de-facto data contract
    # (tests pin trajectories on seeded sequences): the default corridor
    # samples landmarks FIRST, exactly as it always did; only the
    # custom-trajectory path defers landmark sampling until the poses
    # are known.
    if trajectory is None:
        depth_span = speed * num_frames + 40.0
        Xw = np.stack([
            rng.uniform(-25, 25, num_points),
            rng.uniform(-4, 3, num_points),
            rng.uniform(3.0, depth_span, num_points),
        ], axis=-1)
    if num_patterns and num_patterns < num_points:
        # repetitive texture: few distinct patches cycled over landmarks.
        # Drawn from the imaging stream so legacy seeds stay untouched.
        prng = np.random.default_rng((seed, 0xC0FFEE))
        bank = prng.integers(40, 256, size=(num_patterns, patch, patch)
                             ).astype(np.float32)
        patterns = bank[np.arange(num_points) % num_patterns]
    elif pattern_type == "corner":
        # "physical corner" landmarks: four quadrants of distinct random
        # intensities meeting at the patch CENTER, plus low-amplitude
        # noise for per-landmark uniqueness.  Unlike white-noise patches
        # (whose Harris maxima land anywhere in the patch and differ
        # per view), these give every landmark ONE dominant, centered,
        # view-repeatable corner whose descriptor window stays inside
        # the patch — the synthetic analog of object corners that real
        # detectors re-fire on across revisits.  Drawn from a separate
        # stream so legacy seeds stay untouched.
        prng = np.random.default_rng((seed, 0xC04E4))
        h = patch // 2
        # ONE bright quadrant whose inner corner sits at the patch
        # center — an L-corner, the structure Harris is built for.  (An
        # X-junction checkerboard was tried first and fails subtly: the
        # sign-reversing gradients across the junction partially cancel
        # inside the Sobel aperture, so the junction scores BELOW the
        # incidental rim corners and each view locks onto a different
        # maximum.)  Random orientation (which quadrant is bright) and
        # intensity make landmarks distinguishable; noise adds texture.
        v1 = prng.uniform(140.0, 245.0, num_points)
        quad = prng.integers(0, 4, num_points)
        ind = np.zeros((num_points, patch, patch), np.float32)
        sl = [(slice(None, h + 1), slice(None, h + 1)),
              (slice(None, h + 1), slice(h, None)),
              (slice(h, None), slice(None, h + 1)),
              (slice(h, None), slice(h, None))]
        for k in range(4):
            rows, cols = sl[k]
            ind[quad == k, rows, cols] = 1.0
        # Modulate by a radial Gaussian so edge CONTRAST peaks at the
        # central corner and decays outward with NO outer rim.  (Two
        # earlier designs failed measurably: an X-junction checkerboard
        # — sign-reversing gradients cancel inside the Sobel aperture,
        # rim corners outscore the junction — and any hard/feathered
        # outline, whose rim out-responds the center so each view locks
        # onto a DIFFERENT incidental maximum.)
        c = patch // 2
        yy, xx = np.mgrid[0:patch, 0:patch]
        g = np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2.0 * 2.5 ** 2))
        tex = ind * (v1[:, None, None] - 16.0) \
            + prng.normal(0.0, 25.0, ind.shape)
        patterns = (16.0 + tex * g[None].astype(np.float32)
                    ).astype(np.float32)
        # mild band-limit for subpixel-phase-stable responses (no
        # contrast renorm — it would resurrect the rim)
        from scipy.ndimage import gaussian_filter

        patterns = gaussian_filter(patterns, sigma=(0.0, 0.8, 0.8),
                                   mode="nearest")
    else:
        patterns = rng.integers(40, 256, size=(num_points, patch, patch)
                                ).astype(np.float32)
    if pattern_smooth > 0:
        from scipy.ndimage import gaussian_filter

        patterns = gaussian_filter(
            patterns, sigma=(0.0, pattern_smooth, pattern_smooth),
            mode="nearest")
        # restore per-pattern contrast lost to the low-pass (Harris
        # responses and descriptor SNR stay comparable to the sharp case)
        lo = patterns.min(axis=(1, 2), keepdims=True)
        hi = patterns.max(axis=(1, 2), keepdims=True)
        patterns = 40.0 + (patterns - lo) / np.maximum(hi - lo, 1e-6) * 215.0

    # Trajectory: per-frame camera motion M_k expressed in the previous
    # camera frame (forward +z with a gentle yaw).  World-from-camera poses
    # compose as C_k = C_{k-1} @ M_k; the quantity the solver estimates is
    # Tr_k = M_k^-1 (points move opposite to the camera in camera coords),
    # and the reference's pose chain pose_k = pose_{k-1} @ Tr_k^-1 then
    # reproduces C_k exactly.
    if trajectory is None:
        cam_steps = np.zeros((num_frames, 6))
        for k in range(1, num_frames):
            cam_steps[k] = [0.0,
                            yaw_rate * (1 + 0.2 * np.sin(k / 3.0)), 0.0,
                            0.02 * np.sin(k / 5.0), 0.0, speed]
    else:
        cam_steps = np.asarray(trajectory, np.float64)
        assert cam_steps.shape == (num_frames, 6)
    M = np.asarray(pose_vector_to_matrix(cam_steps))  # (T, 4, 4)
    gt_poses = np.zeros_like(M)
    gt_poses[0] = np.eye(4)
    for k in range(1, num_frames):
        gt_poses[k] = gt_poses[k - 1] @ M[k]

    # Custom trajectories: a box around everywhere the camera goes so
    # features exist in view on every leg of e.g. a closed loop.
    if trajectory is not None:
        pos = gt_poses[:, :3, 3]
        mx, my, mz = field_margin
        lo = pos.min(axis=0) - np.array([mx, my, mz])
        hi = pos.max(axis=0) + np.array([mx, my - 1.0, mz])
        Xw = np.stack([
            rng.uniform(lo[0], hi[0], num_points),
            rng.uniform(-4, 3, num_points),
            rng.uniform(lo[2], hi[2], num_points),
        ], axis=-1)
    from libviso_tpu.geometry.se3 import matrix_to_pose_vector
    motions = np.asarray(matrix_to_pose_vector(np.linalg.inv(M)))

    img = imaging or Imaging()
    irng = np.random.default_rng((seed, 0xD1CE))  # imaging-only stream
    occl = (_OccluderField(irng, img.num_occluders, img.occluder_size,
                           img.occluder_speed, width, height)
            if img.num_occluders else None)
    # exposure/bias random walks (shared across views) + per-frame L/R
    # gain mismatch; frame 0 starts at nominal
    log_gain = np.cumsum(
        np.concatenate([[0.0], irng.normal(0, img.exposure_drift,
                                           num_frames - 1)]))
    bias = np.cumsum(
        np.concatenate([[0.0], irng.normal(0, img.bias_drift,
                                           num_frames - 1)]))
    lr_dgain = irng.normal(0, img.lr_gain_mismatch, num_frames)

    def _apply_imaging(im1, im2, k):
        if occl is not None:
            occl.paint(im1, im2, k)
        if img.blur_sigma > 0:
            im1 = _gaussian_blur(im1, img.blur_sigma)
            im2 = _gaussian_blur(im2, img.blur_sigma)
        g1 = np.exp(log_gain[k]) * img.overexposure_gain
        g2 = np.exp(log_gain[k] + lr_dgain[k]) * img.overexposure_gain
        im1 = g1 * im1 + bias[k]
        im2 = g2 * im2 + bias[k]
        if img.noise_sigma > 0:
            im1 = im1 + irng.normal(0, img.noise_sigma, im1.shape)
            im2 = im2 + irng.normal(0, img.noise_sigma, im2.shape)
        im1 = np.clip(im1, 0, 255).astype(np.float32)
        im2 = np.clip(im2, 0, 255).astype(np.float32)
        if img.quantize:
            im1 = np.round(im1)
            im2 = np.round(im2)
        return im1, im2

    frames = []
    gt_projections = []
    for k in range(num_frames):
        W = np.linalg.inv(gt_poses[k])  # camera-from-world
        Xc = Xw @ W[:3, :3].T + W[:3, 3]
        z = Xc[:, 2]
        vis = z > 1.0
        ul = f * Xc[:, 0] / z + cu
        vl = f * Xc[:, 1] / z + cv
        ur = f * (Xc[:, 0] - base) / z + cu

        if img.rs_fraction > 0 and num_frames > 1:
            # Rolling shutter (Imaging.rs_fraction): a landmark imaged
            # on row v sees the camera advanced by rs*(v/H) of the NEXT
            # frame's motion.  The row depends on the (shifted)
            # projection, so one fixed-point iteration: project at the
            # start-of-readout pose (above), derive per-landmark row
            # times, re-project under the per-landmark advanced pose.
            step_next = cam_steps[min(k + 1, num_frames - 1)]
            a = (img.rs_fraction * np.clip(vl, 0.0, height - 1.0)
                 / max(height - 1.0, 1.0))
            Mi = _pose_matrix_np(a[:, None] * step_next[None, :])
            R, t = Mi[:, :3, :3], Mi[:, :3, 3]
            # camera_i-from-world = inv(Mi) @ W: Xc_i = R^T (Xc - t)
            Xc = np.einsum("nji,nj->ni", R, Xc - t)
            z = Xc[:, 2]
            vis = z > 1.0
            ul = f * Xc[:, 0] / z + cu
            vl = f * Xc[:, 1] / z + cv
            ur = f * (Xc[:, 0] - base) / z + cu

        im1 = rng.normal(16.0, 2.0, size=(height, width)).astype(np.float32)
        im2 = rng.normal(16.0, 2.0, size=(height, width)).astype(np.float32)
        order = np.argsort(-z)  # paint far landmarks first (near overwrite)
        for i in order:
            if not vis[i]:
                continue
            if subpixel_render:
                _stamp_bilinear(im1, float(ul[i]), float(vl[i]), patterns[i])
                _stamp_bilinear(im2, float(ur[i]), float(vl[i]), patterns[i])
            else:
                x1, y1 = int(round(ul[i])), int(round(vl[i]))
                x2 = int(round(ur[i]))
                _stamp(im1, x1, y1, patterns[i])
                _stamp(im2, x2, y1, patterns[i])
        im1, im2 = np.clip(im1, 0, 255), np.clip(im2, 0, 255)
        if imaging is not None:
            im1, im2 = _apply_imaging(im1, im2, k)
        frames.append((im1, im2))
        gt_projections.append(
            np.stack([ul, vl, ur, vis.astype(np.float64)], axis=-1))

    return SyntheticSequence(frames=frames, gt_poses=gt_poses,
                             gt_motions=motions, P1=P1, P2=P2,
                             gt_projections=gt_projections)
