"""Essential/fundamental matrix estimation and pose recovery (SURVEY.md C3).

The reference's mono path calls OpenCV's ``findEssentialMat`` (5-point +
RANSAC, src/viso.cpp:1384) and then *stops* — it never recovers R, t or
chains poses (src/viso.cpp:1393-1395).  This build offers both minimal
solvers inside a fully batched RANSAC — the **8-point** estimator (one
batched SVD over all hypotheses) and the **Nister 5-point**
(geometry/five_point.py, exact reference parity, robust to planar scenes) —
and completes the pipeline: E -> (R, t) by cheirality voting,
scale-ambiguous pose chaining.

Every product here and in five_point.py states ``precision="highest"``.
On a GPU the default is TF32 (11 significant bits), at which the mono
path's per-frame rotations on an H100 departed from the CPU's by 2.2e-3
rad instead of 2.4e-4.  Full f32 in any one group of products (5-point
solver, RANSAC scoring and depths, pose refit and scale bundle) left
0.9e-3 to 2.0e-3 rad, so all of them carry it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.geometry.mvg import e2h, sampson_distance
from libviso_tpu.ops.topk import topk_auto
from libviso_tpu.utils.stats import masked_median_abs


def normalize_points(x, K):
    """Pixel -> normalized camera coordinates via K^-1 (zero distortion).

    The ``undistortPoints(x, K, dist=None)`` analog (src/viso.cpp:1382-1383).
    """
    K = jnp.asarray(K)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    y = (jnp.asarray(x)[..., 1] - cy) / fy
    xn = (jnp.asarray(x)[..., 0] - cx - skew * y) / fx
    return jnp.stack([xn, y], axis=-1)


def eight_point_E(x1, x2, weights=None):
    """Essential matrix from >= 8 normalized correspondences (batched).

    Hartley's normalized 8-point algorithm with the essential-matrix
    projection (singular values -> (s, s, 0), s = mean of the two largest).
    ``x1``/``x2`` are (..., N, 2) normalized coordinates with x2' E x1 = 0.
    ``weights`` (0/1 mask or soft weights) excludes rows with fixed shapes.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    h1 = e2h(x1)
    h2 = e2h(x2)
    # rows of the DLT system: kron(x1_h, x2_h) ordered for vec(E) row-major
    A = jnp.einsum("...ni,...nj->...nij", h2, h1, precision="highest").reshape(
        x1.shape[:-1] + (9,))
    if weights is not None:
        A = A * weights[..., None]
    # least-squares null vector via SVD of A (batched).  full_matrices=True
    # is required: a minimal 8x9 system's null vector lives in the 9th right
    # singular vector, which the thin SVD omits.
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    E = vt[..., -1, :].reshape(x1.shape[:-2] + (3, 3))
    # project onto the essential manifold
    U, s, Vt = jnp.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    S = jnp.zeros_like(E).at[..., 0, 0].set(sm).at[..., 1, 1].set(sm)
    E = jnp.matmul(jnp.matmul(U, S, precision="highest"), Vt,
                   precision="highest")
    return E


def decompose_E(E):
    """The four (R, t) candidates of an essential matrix.

    Returns (Rs (..., 4, 3, 3), ts (..., 4, 3)), ||t|| = 1.  Convention:
    x2 ~ R x1 + t (motion of points from camera 1 into camera 2 frame).
    """
    E = jnp.asarray(E)
    U, _, Vt = jnp.linalg.svd(E)
    # make U, Vt proper rotations (the sign flips on U's last column are
    # absorbed by the +-t candidates)
    U = U.at[..., :, 2].multiply(jnp.where(jnp.linalg.det(U) < 0, -1.0, 1.0)[..., None])
    Vt = Vt.at[..., 2, :].multiply(jnp.where(jnp.linalg.det(Vt) < 0, -1.0, 1.0)[..., None])
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], E.dtype)
    Ra = jnp.matmul(jnp.matmul(U, W, precision="highest"), Vt,
                    precision="highest")
    Rb = jnp.matmul(jnp.matmul(U, W.T, precision="highest"), Vt,
                    precision="highest")
    t = U[..., :, 2]
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    Rs = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def _depths(R, t, x1, x2):
    """Depths of triangulated points in both cameras for candidate (R, t).

    Midpoint-free linear triangulation specialized for normalized cameras
    P1 = [I|0], P2 = [R|t]: solve per point for z1 from
    x2_h x (R x1_h z1 + t) = 0 in least squares.
    """
    h1 = e2h(x1)  # (..., N, 3)
    Rx1 = jnp.einsum("...ij,...nj->...ni", R, h1, precision="highest")
    h2 = e2h(x2)
    # cross-product matrix application: c = h2 x (Rx1 * z + t) = 0
    cross_R = jnp.cross(h2, Rx1)
    cross_t = jnp.cross(h2, jnp.broadcast_to(t[..., None, :], h2.shape))
    # z * cross_R + cross_t = 0 -> z = -<cross_R, cross_t>/<cross_R, cross_R>
    num = -jnp.sum(cross_R * cross_t, axis=-1)
    den = jnp.sum(cross_R * cross_R, axis=-1)
    z1 = num / jnp.maximum(den, 1e-12)
    X1 = h1 * z1[..., None]
    X2 = (jnp.einsum("...ij,...nj->...ni", R, X1, precision="highest")
          + t[..., None, :])
    return z1, X2[..., 2]


def two_view_depths(R, t, x1, x2):
    """Public alias of `_depths`: per-point depths (z1, z2) of the
    triangulated correspondences in camera 1 ([I|0]) and camera 2 ([R|t]),
    under x2 ~ R x1 + t.  Scale-propagation (pipeline/mono.py) compares
    these depths across consecutive essential-matrix steps."""
    return _depths(R, t, x1, x2)


def _sampson_residual(E, x1, x2):
    """SIGNED first-order geometric (Sampson) epipolar residual.

    r = x2' E x1 / sqrt(|(E x1)_xy|^2 + |(E' x2)_xy|^2) — the signed
    square root of `mvg.sampson_distance`.  GN on this residual is the
    standard ML refinement of a relative pose under isotropic noise.
    """
    h1 = e2h(x1)
    h2 = e2h(x2)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, h1, precision="highest")
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, h2, precision="highest")
    num = jnp.sum(h2 * Ex1, axis=-1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num / jnp.sqrt(jnp.maximum(den, 1e-18))


def _skew(v):
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1)], axis=-2)


def _expm_so3(w):
    """Rodrigues exponential of a (3,) axis-angle vector."""
    th = jnp.sqrt(jnp.sum(w * w) + 1e-24)
    K = _skew(w / th)
    s, c = jnp.sin(th), jnp.cos(th)
    return (jnp.eye(3, dtype=w.dtype) + s * K
            + (1.0 - c) * jnp.matmul(K, K, precision="highest"))


def _t_basis(t):
    """(3, 2) orthonormal basis of the plane perpendicular to t."""
    # pick the world axis least aligned with t as the seed
    a = jnp.eye(3, dtype=t.dtype)[jnp.argmin(jnp.abs(t))]
    b1 = jnp.cross(t, a)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(t, b1)
    b2 = b2 / jnp.maximum(jnp.linalg.norm(b2), 1e-12)
    return jnp.stack([b1, b2], axis=-1)




def refine_relative_pose(R, t, x1, x2, weights, iters: int = 8,
                         damping: float = 1e-6):
    """Gauss-Newton ML refinement of a relative pose on its 5-dof manifold.

    RANSAC + linear refit leaves the translation DIRECTION several degrees
    off under small baselines (the linear 8-point cost is algebraic, not
    geometric); this polish minimizes the weighted Sampson error over
    (R, t/|t|) — rotation on SO(3) via right-multiplied exponential
    coordinates, translation on the unit sphere via its 2-dof tangent
    basis — which is the accuracy step OpenCV's findEssentialMat also
    lacks and the reference never reached (src/viso.cpp:1393-1395).

    Guarded: each iteration keeps the update only if the weighted cost
    decreases, so a diverging step (near-degenerate weight sets) falls
    back to the input pose.  Fixed shapes; jit/vmap-safe.

    Args:
      R: (3, 3) initial rotation (convention x2 ~ R x1 + t).
      t: (3,) initial translation, any nonzero norm (normalized inside).
      x1, x2: (N, 2) normalized correspondences.
      weights: (N,) nonneg weights (0 excludes a row; typically the
        RANSAC inlier mask).
      iters: GN iterations (static).
      damping: Levenberg ridge relative to the mean JtJ diagonal.

    Returns (R, t) with |t| = 1.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    w = jnp.asarray(weights, x1.dtype)
    active = w > 0
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def resid_at(R, t):
        return _sampson_residual(jnp.matmul(_skew(t), R,
                                            precision="highest"), x1, x2)

    def robust_w(r):
        # Huber IRLS weights at the 1.345-sigma knee, sigma from the MAD
        # of the active residuals: a plain L2 Sampson cost walks to an
        # optimum pulled ~3 deg off by sub-threshold contaminated inliers
        # (aliased matches, overlap corners); the robust knee caps their
        # pull while true inliers keep unit weight.
        sig = 1.4826 * masked_median_abs(r, active) + 1e-9
        knee = 1.345 * sig
        return w * jnp.minimum(1.0, knee / jnp.maximum(jnp.abs(r), 1e-18))

    def body(carry, _):
        R, t = carry
        B = _t_basis(t)

        def resid(p):
            Rp = jnp.matmul(R, _expm_so3(p[:3]), precision="highest")
            tp = t + jnp.einsum("ij,j->i", B, p[3:5], precision="highest")
            tp = tp / jnp.maximum(jnp.linalg.norm(tp), 1e-12)
            E = jnp.matmul(_skew(tp), Rp, precision="highest")
            return _sampson_residual(E, x1, x2)

        p0 = jnp.zeros((5,), x1.dtype)
        r0 = resid(p0)
        wr = robust_w(r0)
        c0 = jnp.sum(wr * r0 * r0)
        J = jax.jacfwd(resid)(p0)                       # (N, 5)
        Jw = J * wr[:, None]
        H = jnp.matmul(J.T, Jw, precision="highest")    # (5, 5)
        g = jnp.einsum("ni,n->i", Jw, r0, precision="highest")
        lam = damping * jnp.trace(H) / 5.0 + 1e-12
        delta = -jnp.linalg.solve(H + lam * jnp.eye(5, dtype=H.dtype), g)
        R1 = jnp.matmul(R, _expm_so3(delta[:3]), precision="highest")
        t1 = t + jnp.einsum("ij,j->i", B, delta[3:5], precision="highest")
        t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-12)
        # guard under the SAME weights (IRLS inner step must not be
        # judged across a weight change)
        r1 = resid_at(R1, t1)
        c1 = jnp.sum(wr * r1 * r1)
        ok = jnp.isfinite(c1) & (c1 < c0)
        R = jnp.where(ok, R1, R)
        t = jnp.where(ok, t1, t)
        return (R, t), None

    (R, t), _ = jax.lax.scan(body, (R, t), None, length=iters)
    return R, t


def depth_log_grads(R, t, x1, x2):
    """Per-point gradients of log triangulated depths w.r.t. pose error.

    For the pair (R, t) (convention x2 ~ R x1 + t, |t| = 1) returns
    ``(g1, g2)``, each (N, 5): the derivative of ``log z1`` / ``log z2``
    (depths from `two_view_depths`) with respect to a 5-dof perturbation
    ``p`` of the pose — ``R <- R exp([p_0:3])``, ``t`` moved in its
    2-dof tangent basis by ``p_3:5`` — evaluated at p = 0.

    A residual pose error delta warps every triangulated depth by
    ``exp(g . delta)`` to first order; the mono scale-propagation
    regression (pipeline/mono.py) uses these fields as covariates to
    separate the true inter-step scale from BOTH pairs' pose-error
    warps, which a plain median ratio cannot (the warp's field average
    biases it several percent per pair).
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    B = _t_basis(t)

    def logz(p):
        Rp = jnp.matmul(R, _expm_so3(p[:3]), precision="highest")
        tp = t + jnp.einsum("ij,j->i", B, p[3:5], precision="highest")
        tp = tp / jnp.maximum(jnp.linalg.norm(tp), 1e-12)
        z1, z2 = _depths(Rp, tp, x1, x2)
        eps = jnp.asarray(1e-6, x1.dtype)
        return jnp.stack([jnp.log(jnp.maximum(z1, eps)),
                          jnp.log(jnp.maximum(z2, eps))], axis=0)

    J = jax.jacfwd(logz)(jnp.zeros((5,), x1.dtype))  # (2, N, 5)
    return J[0], J[1]


def pnp_refine_pose(R, t, X_prev, x_cur, weights, iters: int = 8,
                    huber: float = 4e-3, damping: float = 1e-6):
    """Motion-only PnP: GN over the FULL 6-dof (R, t) given fixed 3D points.

    Convention matches the mono pipeline's step transform (cur -> prev):
    ``X_prev = R X_cur + t``, so a landmark known in the previous camera
    projects into the current one at pi(R^T (X_prev - t)).  Because t is
    unconstrained (not unit-norm), the optimum's ``|t|`` IS the step
    length in the units of ``X_prev`` — this is how monocular relative
    scale becomes observable through landmarks shared with the previous
    pair (VERDICT r1 #3).  Reprojection weighting also makes it the
    statistically right scale estimator: near-FOE landmarks, whose
    two-view depths are hypersensitive to direction error, contribute
    almost nothing to d(residual)/d|t| here.

    Huber-IRLS on the residual norm (``huber`` in normalized units;
    4e-3 ~ 1.5-3 px at KITTI-ish focals) + cost-guarded steps.

    Args:
      R: (3, 3) initial rotation.  t: (3,) initial translation (SCALED —
        e.g. unit direction times a median depth-ratio seed).
      X_prev: (N, 3) landmark positions in the previous camera.
      x_cur: (N, 2) normalized observations in the current camera.
      weights: (N,) nonneg weights (0 = excluded).

    Returns (R, t) — scale ratio = |t|.
    """
    X_prev = jnp.asarray(X_prev)
    x_cur = jnp.asarray(x_cur)
    w0 = jnp.asarray(weights, x_cur.dtype)

    def resid_of(R, t):
        Xc = jnp.einsum("ji,nj->ni", R, X_prev - t[None, :])
        z = jnp.maximum(Xc[..., 2], 1e-6)
        return Xc[..., :2] / z[..., None] - x_cur  # (N, 2)

    def huber_w(r):
        nrm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-18)
        return jnp.minimum(1.0, huber / nrm)

    def cost(R, t):
        r = resid_of(R, t)
        # Huber rho summed over points (weights w0 select support)
        nrm2 = jnp.sum(r * r, axis=-1)
        nrm = jnp.sqrt(nrm2 + 1e-18)
        rho = jnp.where(nrm <= huber, nrm2,
                        2.0 * huber * nrm - huber * huber)
        return jnp.sum(w0 * rho)

    def body(carry, _):
        R, t, c0 = carry

        def resid(p):
            Rp = jnp.matmul(R, _expm_so3(p[:3]), precision="highest")
            return resid_of(Rp, t + p[3:6]).reshape(-1)

        p0 = jnp.zeros((6,), x_cur.dtype)
        r0 = resid(p0)
        wi = (w0 * huber_w(r0.reshape(-1, 2))).repeat(2)
        J = jax.jacfwd(resid)(p0)                       # (2N, 6)
        Jw = J * wi[:, None]
        H = jnp.matmul(J.T, Jw, precision="highest")
        g = jnp.einsum("ni,n->i", Jw, r0, precision="highest")
        lam = damping * jnp.trace(H) / 6.0 + 1e-12
        delta = -jnp.linalg.solve(H + lam * jnp.eye(6, dtype=H.dtype), g)
        R1 = jnp.matmul(R, _expm_so3(delta[:3]), precision="highest")
        t1 = t + delta[3:6]
        c1 = cost(R1, t1)
        ok = jnp.isfinite(c1) & (c1 < c0)
        R = jnp.where(ok, R1, R)
        t = jnp.where(ok, t1, t)
        return (R, t, jnp.where(ok, c1, c0)), None

    (R, t, _), _ = jax.lax.scan(body, (R, t, cost(R, t)), None,
                                length=iters)
    return R, t


def three_view_bundle(R1, t1, x_a, R2, t2, x_b, x_c, z0, weights,
                      iters: int = 10, huber: float = 4e-3,
                      damping: float = 1e-4):
    """Three-view bundle adjustment for monocular relative scale.

    The statistically sound scale estimator (pipeline/mono.py, VERDICT r1
    #3): any estimator built on RATIOS of two-view triangulated depths is
    biased toward 1, because midpoint-free triangulation ``z = a.b/|b|^2``
    is a regression slope with a NOISY denominator — errors-in-variables
    dilution shrinks each depth by ~sigma^2/parallax^2, hits the
    smaller-baseline pair harder, and attenuates |log ratio| by 10-20% on
    slow synthetic steps (measured).  This bundle instead maximizes
    likelihood directly against the raw observations in all three frames,
    where no noisy denominator appears: first-order unbiased.

    Geometry (camera b is the middle frame, the anchor):
      pair 1:  X_a = R1 X_b + t1   with the GAUGE |t1| = 1
      pair 2:  X_b = R2 X_c + t2   with FREE t2 — |t2| IS the scale of
               step 2 in step-1 baseline units
      landmark i:  X_b_i = z_i * h(x_b_i)  (anchored to its frame-b ray)

    Unknowns: 5-dof pose-1 correction (SO(3) x unit sphere), 6-dof
    pose-2 correction, per-landmark log-depths.  Per-landmark residuals
    are the reprojections into frames a and c (4 values).  Solved by
    damped GN with per-landmark Schur complement (the landmark block is
    1x1 — the whole reduction is a vmapped rank-1 sum), Huber-IRLS on
    per-frame residual norms, cost-guarded steps.  Fixed shapes, O(N)
    per iteration, jit-safe.

    Args:
      R1, t1: pair-1 pose (frame-b -> frame-a), |t1| normalized inside.
      x_a: (N, 2) normalized observations in frame a.
      R2, t2: pair-2 pose (frame-c -> frame-b); t2 seeded SCALED (e.g.
        unit direction times a median-ratio seed).
      x_b, x_c: (N, 2) normalized observations in frames b and c.
      z0: (N,) initial frame-b depths in step-1 units.
      weights: (N,) nonneg weights (0 excludes a track).
      huber: knee on per-frame residual norm, normalized units.

    Returns (R1, t1, R2, t2, z): refined poses and depths; the relative
    scale is ``|t2|``.
    """
    x_a = jnp.asarray(x_a)
    x_b = jnp.asarray(x_b)
    x_c = jnp.asarray(x_c)
    w0 = jnp.asarray(weights, x_b.dtype)
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-12)
    h_b = e2h(x_b)                                   # (N, 3) anchor rays
    u0 = jnp.log(jnp.clip(z0, 1e-3, 1e5))
    eps = jnp.asarray(1e-6, x_b.dtype)

    def resid_one(p, du, u_i, hb_i, xa_i, xc_i, R1c, t1c, R2c, t2c):
        """(4,) reprojection residual of one landmark under the 11-dof
        pose perturbation p and its own log-depth perturbation du."""
        B1 = _t_basis(t1c)
        R1p = jnp.matmul(R1c, _expm_so3(p[0:3]), precision="highest")
        t1p = t1c + jnp.einsum("ij,j->i", B1, p[3:5], precision="highest")
        t1p = t1p / jnp.maximum(jnp.linalg.norm(t1p), 1e-12)
        R2p = jnp.matmul(R2c, _expm_so3(p[5:8]), precision="highest")
        t2p = t2c + p[8:11]
        Xb = jnp.exp(u_i + du) * hb_i
        Xa = jnp.einsum("ij,j->i", R1p, Xb, precision="highest") + t1p
        Xc = jnp.einsum("ji,j->i", R2p, Xb - t2p, precision="highest")
        ra = Xa[:2] / jnp.maximum(Xa[2], eps) - xa_i
        rc = Xc[:2] / jnp.maximum(Xc[2], eps) - xc_i
        return jnp.concatenate([ra, rc])

    def residuals(u, R1c, t1c, R2c, t2c):
        p0 = jnp.zeros((11,), x_b.dtype)
        return jax.vmap(
            lambda u_i, hb_i, xa_i, xc_i: resid_one(
                p0, 0.0, u_i, hb_i, xa_i, xc_i, R1c, t1c, R2c, t2c)
        )(u, h_b, x_a, x_c)                           # (N, 4)

    active = w0 > 0

    def frame_weights(r):
        # Tukey-biweight IRLS per frame observation (replicated over its
        # two residual components), scale from the MAD of the active
        # residual norms with ``huber`` as a floor.  The redescending
        # weight ZEROES gross contaminators (non-rigid corners, aliased
        # matches at the 1-3 px level) that a Huber knee only
        # downweights — on dense synthetic fields those carry enough
        # mass to tilt the translation direction by degrees.
        na = jnp.sqrt(jnp.sum(r[:, :2] ** 2, axis=-1) + 1e-18)
        nc = jnp.sqrt(jnp.sum(r[:, 2:] ** 2, axis=-1) + 1e-18)

        def tukey(n):
            sig = jnp.maximum(1.4826 * masked_median_abs(n, active),
                              huber / 4.685)
            q = n / (4.685 * sig)
            return jnp.where(q < 1.0, (1.0 - q * q) ** 2, 0.0)

        wa = tukey(na)
        wc = tukey(nc)
        return w0[:, None] * jnp.stack([wa, wa, wc, wc], axis=-1)  # (N, 4)

    def cost_of(r, wf):
        return jnp.sum(wf * r * r)

    def body(carry, _):
        R1c, t1c, R2c, t2c, u = carry
        p0 = jnp.zeros((11,), x_b.dtype)

        r = residuals(u, R1c, t1c, R2c, t2c)          # (N, 4)
        wf = frame_weights(r)
        c0 = cost_of(r, wf)

        Jp, Ju = jax.vmap(
            jax.jacfwd(resid_one, argnums=(0, 1)),
            in_axes=(None, None, 0, 0, 0, 0, None, None, None, None),
        )(p0, 0.0, u, h_b, x_a, x_c, R1c, t1c, R2c, t2c)
        # Jp: (N, 4, 11), Ju: (N, 4)

        JpW = Jp * wf[:, :, None]
        H_pp = jnp.einsum("nri,nrj->ij", JpW, Jp,
                          precision="highest")        # (11, 11)
        h_pu = jnp.einsum("nri,nr->ni", JpW, Ju,
                          precision="highest")        # (N, 11)
        h_uu = jnp.sum(wf * Ju * Ju, axis=-1)         # (N,)
        g_p = jnp.einsum("nri,nr->i", JpW, r, precision="highest")  # (11,)
        g_u = jnp.sum(wf * Ju * r, axis=-1)           # (N,)

        lam = damping * jnp.trace(H_pp) / 11.0 + 1e-12
        lam_u = damping * h_uu + 1e-9
        d_uu = h_uu + lam_u
        S = (H_pp + lam * jnp.eye(11, dtype=H_pp.dtype)
             - jnp.einsum("ni,nj->ij", h_pu / d_uu[:, None], h_pu,
                           precision="highest"))
        gs = g_p - jnp.einsum("ni,n->i", h_pu, g_u / d_uu, precision="highest")
        dp = -jnp.linalg.solve(S, gs)
        du = -(g_u + jnp.einsum("ni,i->n", h_pu, dp,
                                precision="highest")) / d_uu

        B1 = _t_basis(t1c)
        R1n = jnp.matmul(R1c, _expm_so3(dp[0:3]), precision="highest")
        t1n = t1c + jnp.einsum("ij,j->i", B1, dp[3:5], precision="highest")
        t1n = t1n / jnp.maximum(jnp.linalg.norm(t1n), 1e-12)
        R2n = jnp.matmul(R2c, _expm_so3(dp[5:8]), precision="highest")
        t2n = t2c + dp[8:11]
        un = jnp.clip(u + du, -7.0, 12.0)

        # guard under the SAME weights (IRLS inner comparison)
        r1 = residuals(un, R1n, t1n, R2n, t2n)
        c1 = cost_of(r1, wf)
        ok = jnp.isfinite(c1) & (c1 < c0) & jnp.all(jnp.isfinite(dp))
        R1c = jnp.where(ok, R1n, R1c)
        t1c = jnp.where(ok, t1n, t1c)
        R2c = jnp.where(ok, R2n, R2c)
        t2c = jnp.where(ok, t2n, t2c)
        u = jnp.where(ok, un, u)
        return (R1c, t1c, R2c, t2c, u), None

    (R1, t1, R2, t2, u), _ = jax.lax.scan(
        body, (R1, t1, R2, t2, u0), None, length=iters)
    return R1, t1, R2, t2, jnp.exp(u)


def recover_pose(E, x1, x2, valid=None):
    """Select the (R, t) candidate with the most points in front of both
    cameras (OpenCV recoverPose analog — the step the reference never
    implemented, SURVEY.md C3).

    Args:
      E: (3, 3) essential matrix (x2' E x1 = 0).
      x1, x2: (N, 2) normalized correspondences.
      valid: optional (N,) mask.

    Returns (R (3,3), t (3,), good (N,) cheirality mask, n_good ()).
    """
    if valid is None:
        valid = jnp.ones(x1.shape[-2], bool)
    Rs, ts = decompose_E(E)  # (4, 3, 3), (4, 3)
    z1, z2 = jax.vmap(lambda R, t: _depths(R, t, x1, x2))(Rs, ts)
    front = (z1 > 0) & (z2 > 0) & valid[None, :]
    counts = jnp.sum(front, axis=-1)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], front[best], counts[best]


class EssentialResult(NamedTuple):
    E: jax.Array          # (3, 3)
    inliers: jax.Array    # (N,) bool
    num_inliers: jax.Array
    ok: jax.Array


def ransac_essential(key, x1, x2, valid=None, num_hypotheses=128,
                     sampson_thresh=1e-5, min_inliers=16,
                     sample_size=8, method="8pt",
                     scoring="msac",
                     soft_refit=False) -> EssentialResult:
    """Batched RANSAC essential-matrix estimation on normalized points.

    All hypotheses evaluated simultaneously: Gumbel-top-k sampling,
    batched minimal solve, Sampson-distance scoring in normalized
    coordinates, final refit on the best support set (weighted 8-point
    over all inliers).

    ``method``: '8pt' (default — one SVD per hypothesis) or '5pt' (the
    Nister minimal solver, geometry/five_point.py — exact reference
    parity with OpenCV findEssentialMat, src/viso.cpp:1384, and immune to
    the planar-scene degeneracy of the 8-point solver).  With '5pt' every
    hypothesis contributes up to 22 candidate models, all scored.

    ``scoring`` (r5, VERDICT r4 #5 estimator round):
      * 'msac' — truncated-quadratic quality at the single threshold
        (Torr & Zisserman; the r2-r4 behavior).
      * 'magsac' — sigma-marginalized quality: the MSAC quality
        AVERAGED over a log-spaced threshold ladder
        (tau/4 .. 4*tau, each normalized by its own tau so scales are
        comparable) — a cheap fixed-shape approximation of MAGSAC++'s
        marginalization over the unknown noise scale.  Model selection
        stops depending on one threshold guess: a model that is only
        best at one tau (overfit to near-threshold points) loses to
        one that dominates across scales.  Costs 4 extra elementwise
        passes over the already-computed (H, N) Sampson matrix —
        negligible next to the minimal solves.
    ``soft_refit`` — replace the refit rounds' 0/1 inlier weights with
      continuous truncated-linear weights max(0, 1 - s/tau) (a
      chi^2-style downweighting): near-threshold points stop yanking
      the least-squares refit with full force.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    N = x1.shape[0]
    if valid is None:
        valid = jnp.ones(N, bool)
    if method == "5pt":
        sample_size = 5

    gumbel = jax.random.gumbel(key, (num_hypotheses, N), dtype=x1.dtype)
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, idx = topk_auto(scores, sample_size)

    if method == "5pt":
        from libviso_tpu.geometry.five_point import five_point_E

        Ec, cand_ok = five_point_E(x1[idx], x2[idx])   # (H, 22, 3, 3)
        E = Ec.reshape((-1, 3, 3))                     # (H*22, 3, 3)
        cand_ok = cand_ok.reshape(-1)
        s = sampson_distance(E[:, None], x1[None], x2[None])
        inl = (s < sampson_thresh) & valid[None, :] & cand_ok[:, None]
    elif method == "8pt":
        E = eight_point_E(x1[idx], x2[idx])  # (H, 3, 3)
        s = sampson_distance(E[:, None], x1[None], x2[None])  # (H, N)
        inl = (s < sampson_thresh) & valid[None, :]
    else:
        raise ValueError(f"unknown method {method!r}")
    counts = jnp.sum(inl, axis=-1)
    # MSAC scoring (truncated quadratic, Torr & Zisserman): maximize
    # sum over inliers of (thresh - d^2), not the 0/1 inlier count.
    # Under structured localization noise (e.g. pixel quantization) a
    # slightly-wrong model can absorb extra near-threshold points and WIN
    # the count while fitting the true inliers worse — measured 10-16 deg
    # of translation-direction error on slow synthetic steps; MSAC keeps
    # the residual-weighted optimum (<1 deg on the same data).
    valid_f = valid[None, :] if method == "8pt" else (
        valid[None, :] & cand_ok[:, None])

    def quality(sd, mask):
        # sd: (..., N) Sampson distances, mask: (..., N) scorable points
        if scoring == "magsac":
            q = 0.0
            for ts in (0.25, 0.5, 1.0, 2.0, 4.0):
                tau = sampson_thresh * ts
                q = q + jnp.sum(
                    jnp.where(mask & (sd < tau), 1.0 - sd / tau, 0.0),
                    axis=-1)
            return q / 5.0
        return jnp.sum(jnp.where(mask & (sd < sampson_thresh),
                                 sampson_thresh - sd, 0.0), axis=-1)

    qual = quality(s, valid_f)
    best = jnp.argmax(qual)

    def refit_weights(sd):
        hard = (sd < sampson_thresh) & valid
        if soft_refit:
            return jnp.where(hard, 1.0 - sd / sampson_thresh,
                             0.0).astype(x1.dtype)
        return hard.astype(x1.dtype)

    w = (jnp.where(inl[best], 1.0 - s[best] / sampson_thresh, 0.0)
         .astype(x1.dtype) if soft_refit else inl[best].astype(x1.dtype))
    E_refit = eight_point_E(x1, x2, weights=w)
    # second refit round on the refreshed support set (IRLS-style): the
    # enlarged inlier set after round 1 sharpens the estimate
    s_1 = sampson_distance(E_refit, x1, x2)
    E_refit = eight_point_E(x1, x2, weights=refit_weights(s_1))
    s_f = sampson_distance(E_refit, x1, x2)
    final = (s_f < sampson_thresh) & valid
    n = jnp.sum(final)
    # LO-RANSAC guard: a least-squares refit can DEGRADE the model (e.g.
    # the linear system goes rank-deficient on planar scenes, where the
    # 5-point minimal model is fine).  Keep whichever model scores better
    # under the same objective that picked the minimal winner.
    qual_refit = quality(s_f, valid)
    keep_refit = qual_refit >= qual[best]
    E_out = jnp.where(keep_refit, E_refit, E[best])
    final = jnp.where(keep_refit, final, inl[best])
    n = jnp.where(keep_refit, n, counts[best])
    return EssentialResult(E=E_out, inliers=final, num_inliers=n,
                           ok=n >= min_inliers)


def undistort_points(x, K, D, iters: int = 5):
    """Pixel -> normalized coordinates with Brown-Conrady undistortion.

    OpenCV undistortPoints semantics with dist = (k1, k2, p1, p2): fixed-
    point iteration inverting the distortion model.  With D = 0 this
    reduces exactly to normalize_points (the reference always passes an
    empty distortion, src/viso.cpp:1382-1383; real cameras need this).
    """
    D = jnp.zeros(4) if D is None else jnp.asarray(D)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    xd = normalize_points(x, K)  # distorted normalized coords
    u = xd
    for _ in range(iters):  # static unroll: tiny
        r2 = jnp.sum(u * u, axis=-1, keepdims=True)
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        ux = u[..., 0:1]
        uy = u[..., 1:2]
        tang = jnp.concatenate(
            [2 * p1 * ux * uy + p2 * (r2 + 2 * ux * ux),
             p1 * (r2 + 2 * uy * uy) + 2 * p2 * ux * uy], axis=-1)
        u = (xd - tang) / radial
    return u
