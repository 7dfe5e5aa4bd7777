"""Gauss-Newton minimization of weighted stereo reprojection error.

The accuracy kernel of the engine (SURVEY.md C12; reference
``minimize_reproj`` src/viso.cpp:1582-1623 and ``compute_J``
src/viso.cpp:1401-1497).

Batched design notes (vs. the reference):
  - The per-point scalar loops become batched tensor expressions over an
    ``(N,)`` point axis; an extra leading axis vmaps over RANSAC hypotheses.
  - Ragged "active" index subsets become a per-point weight vector: weight 0
    removes a point from the normal equations exactly (fixed shapes, no
    gathers inside the loop).
  - The iteration is a ``lax.while_loop`` with the same 100-step bound;
    convergence is the *intended* test ``max_j |step_j| <= thresh``.  The
    reference's test has a misplaced parenthesis (src/viso.cpp:1610) making
    it ``fabs(bool)`` — a signed test that also accepts large negative
    steps.  Deliberate, documented divergence (SURVEY.md §3.5).
  - The reference evaluates its per-point weight from the wrong observation
    column when fitting a subsample (``observe(0, i)`` with a local ``i``,
    src/viso.cpp:1449); we weight each active point by its own u-coordinate.
    Deliberate divergence.
  - The 6x6 normal-equation solve uses an equilibrated Cholesky
    factorization (f32-friendly) instead of LU-in-double; singularity is
    reported through a validity flag instead of an early return.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.config import Calib, RansacConfig
from libviso_tpu.geometry.se3 import euler_to_rotation, rotation_derivatives


def stereo_predict(tr, X, calib: Calib):
    """Project previous-frame 3D points into the current stereo pair.

    Matches reference compute_J's prediction block (src/viso.cpp:1486-1489):
    rotate/translate into the current left camera, shift by the baseline for
    the right camera, pinhole-project with (f, cu, cv).

    Args:
      tr: (..., 6) motion (rx, ry, rz, tx, ty, tz), previous -> current.
      X: (..., N, 3) 3D points in the previous left-camera frame.
      calib: rectified calibration.

    Returns:
      predict: (..., N, 4) pixel predictions (u_l, v_l, u_r, v_r).
      Xc: (..., N, 3) the transformed points (current left frame).
    """
    R = euler_to_rotation(tr[..., :3])
    t = tr[..., None, 3:6]
    Xc = jnp.einsum("...ij,...nj->...ni", R, X, precision="highest") + t
    Zc = Xc[..., 2]
    u_l = calib.f * Xc[..., 0] / Zc + calib.cu
    v_l = calib.f * Xc[..., 1] / Zc + calib.cv
    u_r = calib.f * (Xc[..., 0] - calib.base) / Zc + calib.cu
    predict = jnp.stack([u_l, v_l, u_r, v_l], axis=-1)
    return predict, Xc


def _weights(observe, calib: Calib):
    """Center-emphasis weights, reference src/viso.cpp:1447-1449."""
    return 1.0 / (jnp.abs(observe[..., 0] - calib.cu) / abs(calib.cu) + 0.05)


def residual_jacobian(tr, X, observe, calib: Calib):
    """Weighted residuals and the analytic (N, 4, 6) Jacobian.

    Vectorized equivalent of reference ``compute_J`` (src/viso.cpp:1401-1497).
    Residual rows are ordered (u_l, v_l, u_r, v_r); the right-v row equals
    the left-v row exactly as in the reference (rectified cameras share Y, Z
    — src/viso.cpp:1481).

    Returns (residual (..., N, 4), J (..., N, 4, 6), predict (..., N, 4)).
    Residual and J carry the per-point weight; predict does not.
    """
    predict, Xc = stereo_predict(tr, X, calib)
    w = _weights(observe, calib)

    # dXc/dparam: rotational part from the analytic tables, translation = I.
    dR = rotation_derivatives(tr[..., :3])  # (..., 3, 3, 3)
    dXc_rot = jnp.einsum("...pij,...nj->...npi", dR, X)  # (..., N, 3param, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=X.dtype), dXc_rot.shape[:-2] + (3, 3))
    dXc = jnp.concatenate([dXc_rot, eye], axis=-2)  # (..., N, 6, 3xyz)

    Xl, Zc = Xc[..., 0], Xc[..., 2]
    Yl = Xc[..., 1]
    Xr = Xl - calib.base
    dX, dY, dZ = dXc[..., 0], dXc[..., 1], dXc[..., 2]  # (..., N, 6)
    Z2 = (Zc * Zc)[..., None]
    f = calib.f
    # Quotient-rule rows, reference src/viso.cpp:1478-1481.
    Ju_l = f * (dX * Zc[..., None] - Xl[..., None] * dZ) / Z2
    Jv_l = f * (dY * Zc[..., None] - Yl[..., None] * dZ) / Z2
    Ju_r = f * (dX * Zc[..., None] - Xr[..., None] * dZ) / Z2
    J = jnp.stack([Ju_l, Jv_l, Ju_r, Jv_l], axis=-2)  # (..., N, 4, 6)

    residual = observe - predict
    wv = w[..., None]
    return residual * wv, J * wv[..., None], predict


def reprojection_errors_sq(tr, X, observe, calib: Calib):
    """Unweighted squared reprojection error summed over the 4 components.

    The RANSAC inlier score of reference ``get_inliers``
    (src/viso.cpp:1525-1534).
    """
    predict, _ = stereo_predict(tr, X, calib)
    return jnp.sum((observe - predict) ** 2, axis=-1)


def _solve_spd6(A, b, eps=1e-12):
    """Equilibrated Cholesky solve of the 6x6 normal equations.

    Returns (step, ok).  ``ok`` is False when A is (numerically) singular —
    the condition under which the reference aborts GN (src/viso.cpp:1602).
    """
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(A, axis1=-2, axis2=-1), eps))
    scale = 1.0 / d
    As = A * scale[..., :, None] * scale[..., None, :]
    bs = b * scale
    L = jnp.linalg.cholesky(As)
    y = jax.scipy.linalg.solve_triangular(L, bs[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)[..., 0]
    step = x * scale
    ok = jnp.all(jnp.isfinite(step), axis=-1)
    return jnp.where(ok[..., None], step, jnp.zeros_like(step)), ok


class GNResult(NamedTuple):
    tr: jax.Array        # (..., 6) final motion estimate
    converged: jax.Array  # (...,) bool: step-norm test passed
    iters: jax.Array     # (...,) int32: iterations executed


def gauss_newton(X, observe, weights, tr0, calib: Calib,
                 cfg: RansacConfig = RansacConfig()) -> GNResult:
    """Masked Gauss-Newton on the weighted stereo reprojection error.

    Fixed-shape equivalent of reference ``minimize_reproj``
    (src/viso.cpp:1582-1623): iterate ``tr += solve(JtJ, Jt r)`` until the
    step is below ``cfg.converge_thresh`` or ``cfg.gn_iters`` is exhausted.
    Success (the reference's ``true`` return) is ``converged``.

    Args:
      X: (N, 3) previous-frame 3D points (any leading batch dims).
      observe: (N, 4) current-frame observations (u_l, v_l, u_r, v_r).
      weights: (N,) active-set mask / weights: 0 excludes a point exactly.
      tr0: (6,) initial motion (the reference always starts at 0).
      calib, cfg: calibration and solver configuration.

    Fully vmappable: give every argument a leading hypothesis axis to solve
    a whole RANSAC batch in one call.
    """
    wmask = weights

    def body(state):
        tr, _, it, _ = state
        r, J, _ = residual_jacobian(tr, X, observe, calib)
        # r and J already carry the center-emphasis weight; the active-set
        # mask is applied once (to one factor) so excluded points contribute
        # exactly zero to the normal equations.
        Jm = J * wmask[..., None, None]
        A = jnp.einsum("...nri,...nrj->...ij", Jm, J, precision="highest")
        b = jnp.einsum("...nri,...nr->...i", Jm, r, precision="highest")
        if cfg.gn_lm_lambda > 0.0:
            # scale-aware LM ridge (see RansacConfig.gn_lm_lambda)
            diag = jnp.diagonal(A, axis1=-2, axis2=-1)
            A = A + cfg.gn_lm_lambda * diag[..., None] \
                * jnp.eye(6, dtype=A.dtype)
        step, ok = _solve_spd6(A, b)
        tr_new = tr + step
        converged = jnp.max(jnp.abs(step), axis=-1) <= cfg.converge_thresh
        failed = ~ok
        return tr_new, converged, it + 1, failed

    def cond(state):
        _, converged, it, failed = state
        active = ~(converged | failed) & (it < cfg.gn_iters)
        return jnp.any(active)

    tr0 = jnp.asarray(tr0)
    batch_shape = tr0.shape[:-1]
    init = (
        tr0,
        jnp.zeros(batch_shape, dtype=bool),
        jnp.zeros(batch_shape, dtype=jnp.int32),
        jnp.zeros(batch_shape, dtype=bool),
    )

    def masked_body(state):
        tr, converged, it, failed = state
        active = ~(converged | failed) & (it < cfg.gn_iters)
        tr_n, conv_n, it_n, failed_n = body(state)
        keep = active
        return (
            jnp.where(keep[..., None], tr_n, tr),
            jnp.where(keep, conv_n, converged),
            jnp.where(keep, it_n, it),
            jnp.where(keep, failed_n, failed),
        )

    def unrolled_body(state):
        # cfg.gn_unroll masked GN steps per while iteration: the loop's
        # fixed per-iteration overhead (~tens of µs on-device) is paid
        # 1/unroll as often; the masking keeps per-lane semantics
        # IDENTICAL for any unroll factor (converged lanes freeze).
        for _ in range(cfg.gn_unroll):
            state = masked_body(state)
        return state

    tr, converged, iters, failed = jax.lax.while_loop(cond, unrolled_body,
                                                      init)
    return GNResult(tr=tr, converged=converged & ~failed, iters=iters)
