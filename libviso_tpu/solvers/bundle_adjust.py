"""Sliding-window stereo bundle adjustment with Schur-complement reduction.

A capability the reference does not have (each pose uses only frame k-1 -> k,
SURVEY.md §5.7); BASELINE configs 4/5 require it.  Design is batch-first:

  - The window is a fixed-shape problem: W camera poses (6-dof each),
    L landmarks (3-dof each), a dense (W, L) visibility mask, and stereo
    observations (W, L, 4) in (u_l, v_l, u_r, v_r) layout.
  - Each Levenberg-Marquardt-damped Gauss-Newton iteration builds the
    normal equations from batched einsums over the (W, L) observation
    grid: pose blocks U (W, 6, 6), landmark blocks V (L, 3, 3), coupling
    blocks W_kj (W, L, 6, 3).
  - Landmarks are eliminated by the Schur complement
        S = U_bd - W V^-1 W',   rhs = b_p - W V^-1 b_l,
    leaving a dense (6W x 6W) pose system (W <= ~32: tiny), then landmark
    updates by back-substitution.  V^-1 is a batched 3x3 solve.
  - Gauge freedom: pose 0 is frozen (its update rows/cols are masked).
  - Everything is jnp: the landmark axis L is the large one, and every
    reduction over it (U, S, rhs) is an einsum XLA can shard over a mesh
    axis — psum/reduce-scatter across devices come from NamedSharding on the
    (W, L, ...) tensors, no hand-written collectives (SURVEY.md P5/P7).

Parameterization matches the rest of the engine: pose k is the 6-vector
``tr_k`` mapping world points into camera k (Euler-XYZ, se3.py), so the
stereo projection and Jacobians reuse the GN solver's analytic forms.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.config import Calib
from libviso_tpu.geometry.se3 import euler_to_rotation, rotation_derivatives


def _project_all(poses, X, calib: Calib):
    """Stereo predictions of all landmarks in all frames: (W, L, 4).

    Delegates to the GN solver's stereo_predict — (W, 6) poses broadcast
    against (L, 3) landmarks — so BA and the frame solver share ONE
    projection model."""
    from libviso_tpu.solvers.gauss_newton import stereo_predict

    return stereo_predict(poses, X, calib)


def _jacobians(poses, X, Xc, calib: Calib):
    """Analytic Jacobians of the 4 residual rows.

    Returns (A (W, L, 4, 6) wrt pose, B (W, L, 4, 3) wrt landmark).
    """
    dR = rotation_derivatives(poses[:, :3])        # (W, 3, 3, 3)
    # dXc/dpose: rotation params then translation identity: (W, L, 6, 3)
    dXc_rot = jnp.einsum("wpij,lj->wlpi", dR, X)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=X.dtype),
                           dXc_rot.shape[:2] + (3, 3))
    dXc_pose = jnp.concatenate([dXc_rot, eye], axis=2)  # (W, L, 6, 3)
    # dXc/dX = R: (W, 3, 3) broadcast over L -> (W, L, 3param, 3xyz)
    R = euler_to_rotation(poses[:, :3])
    dXc_lm = jnp.broadcast_to(jnp.swapaxes(R, -1, -2)[:, None],
                              dXc_pose.shape[:2] + (3, 3))

    def proj_rows(dXc):
        # dXc: (..., P, 3) parameter-direction derivatives of Xc
        Xl, Yl, Z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        Xr = Xl - calib.base
        dX, dY, dZ = dXc[..., 0], dXc[..., 1], dXc[..., 2]
        Z2 = (Z * Z)[..., None]
        f = calib.f
        Ju_l = f * (dX * Z[..., None] - Xl[..., None] * dZ) / Z2
        Jv_l = f * (dY * Z[..., None] - Yl[..., None] * dZ) / Z2
        Ju_r = f * (dX * Z[..., None] - Xr[..., None] * dZ) / Z2
        return jnp.stack([Ju_l, Jv_l, Ju_r, Jv_l], axis=-2)  # (...,4,P)

    A = proj_rows(dXc_pose)   # (W, L, 4, 6)
    B = proj_rows(dXc_lm)     # (W, L, 4, 3)
    return A, B


class BAResult(NamedTuple):
    poses: jax.Array        # (W, 6) refined camera-from-world motions
    landmarks: jax.Array    # (L, 3) refined world points
    cost: jax.Array         # () final mean squared reprojection error
    initial_cost: jax.Array
    iters: jax.Array


def ba_cost(poses, X, obs, mask, calib: Calib, pose_prior=None,
            prior_weight=None):
    """Mean squared reprojection error over visible observations (plus
    the mean prior penalty when a pose prior is active — acceptance
    control must see the same objective the step minimizes)."""
    predict, _ = _project_all(poses, X, calib)
    r = jnp.where(mask[..., None], obs - predict, 0.0)
    n = jnp.maximum(jnp.sum(mask), 1)
    c = jnp.sum(r * r) / n
    if pose_prior is not None:
        d = poses - pose_prior
        c = c + jnp.sum(prior_weight * d * d) / n
    return c


def bundle_adjust(poses0, X0, obs, mask, calib: Calib, iters: int = 10,
                  damping: float = 1e-4, fix_first: bool = True,
                  pose_prior=None, prior_weight=None,
                  freeze_landmarks: bool = False,
                  freeze_poses: bool = False) -> BAResult:
    """Damped Gauss-Newton window BA with Schur elimination of landmarks.

    Args:
      poses0: (W, 6) initial camera-from-world pose vectors.
      X0: (L, 3) initial world landmarks.
      obs: (W, L, 4) stereo observations.
      mask: (W, L) bool visibility.
      iters: fixed GN/LM iteration count (fixed shapes; cheap iterations).
      damping: Levenberg damping added to U and V diagonals.
      fix_first: freeze pose 0 (gauge).
      pose_prior: optional (W, 6) prior pose vectors — the
        marginalization prior carrying information from the PREVIOUS
        overlapping window into this one (VERDICT r1 #5).  Adds the
        quadratic penalty ``prior_weight * (pose - pose_prior)^2``
        per dof: a diagonal information block, so it drops into the
        Schur-reduced pose system as a block-diagonal addition to U.
      prior_weight: (W, 6) nonneg per-dof weights in px^2-per-unit^2
        (0 rows disable the prior for that pose).
      freeze_landmarks: optimize POSES ONLY against the fixed ``X0``
        (landmark updates zeroed; the Schur system degenerates to the
        U-block).  Diagnostic mode (r5, VERDICT r4 weak #7): comparing
        full BA vs frozen-landmark BA separates gains the acceptance
        gate can see (pose-mediated, visible to the frozen-X0 holdout)
        from gains it is structurally blind to (landmark-mediated) —
        benchmarks/ba_landmark_mediation.py.
      freeze_poses: optimize LANDMARKS ONLY under the fixed poses
        (pose steps zeroed; each landmark solves its independent 3x3
        system).  Used by the cross-fit gate experiment
        (benchmarks/ba_gate_crossfit.py): refit landmarks per pose set
        on training frames, test generalization on held-out frames.

    Returns BAResult; invalid/ill-conditioned steps are skipped (the
    iteration keeps the previous iterate), so the result never diverges
    from a poisoned update.
    """
    W, L = mask.shape
    dtype = poses0.dtype
    maskf = mask.astype(dtype)
    if pose_prior is not None and prior_weight is None:
        raise ValueError("pose_prior requires prior_weight")

    pose_free = jnp.ones((W,), dtype)
    if fix_first:
        pose_free = pose_free.at[0].set(0.0)

    def iteration(carry, _):
        poses, X, prev_cost, lam = carry
        predict, Xc = _project_all(poses, X, calib)
        r = jnp.where(mask[..., None], obs - predict, 0.0)  # (W, L, 4)
        A, B = _jacobians(poses, X, Xc, calib)
        A = A * maskf[..., None, None]
        B = B * maskf[..., None, None]

        # normal-equation blocks
        U = jnp.einsum("wlri,wlrj->wij", A, A, precision="highest")
        V = jnp.einsum("wlri,wlrj->lij", B, B, precision="highest")
        Wkj = jnp.einsum("wlri,wlrj->wlij", A, B, precision="highest")
        b_p = jnp.einsum("wlri,wlr->wi", A, r, precision="highest")
        b_l = jnp.einsum("wlri,wlr->li", B, r, precision="highest")

        if pose_prior is not None:
            # diagonal prior information + its gradient contribution
            U = U + jax.vmap(jnp.diag)(prior_weight)
            b_p = b_p + prior_weight * (pose_prior - poses)

        U = U + lam * jnp.eye(6, dtype=dtype)
        V = V + lam * jnp.eye(3, dtype=dtype)

        if freeze_poses:
            # landmark-only GN: independent 3x3 solves, pose step zero
            S = jnp.broadcast_to(jnp.eye(6, dtype=dtype)[None, None],
                                 (W, W, 6, 6)) * 0.0
            S = S.at[jnp.arange(W), jnp.arange(W)].add(
                jnp.eye(6, dtype=dtype))
            rhs = jnp.zeros_like(b_p)
            Vinv = jnp.linalg.inv(V)
        elif freeze_landmarks:
            # pose-only GN: the system is block-diagonal in poses
            S = jnp.zeros((W, W, 6, 6), dtype)
            S = S.at[jnp.arange(W), jnp.arange(W)].add(U)
            rhs = b_p
            Vinv = jnp.zeros_like(V)
        else:
            # landmark elimination (batched 3x3 inverse)
            Vinv = jnp.linalg.inv(V)                     # (L, 3, 3)
            WVinv = jnp.einsum("wlij,ljk->wlik", Wkj, Vinv,
                               precision="highest")      # (W, L, 6, 3)
            # S is block-dense over pose pairs: (W, W, 6, 6)
            S_off = jnp.einsum("alik,bljk->abij", WVinv, Wkj,
                               precision="highest")
            S = -S_off
            S = S.at[jnp.arange(W), jnp.arange(W)].add(U)
            rhs = b_p - jnp.einsum("wlik,lk->wi", WVinv, b_l,
                                   precision="highest")

        # gauge: zero out frozen pose rows/cols, identity on the diagonal
        free = pose_free
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S = S.at[jnp.arange(W), jnp.arange(W)].add(
            (1.0 - free)[:, None, None] * jnp.eye(6, dtype=dtype))
        rhs = rhs * free[:, None]

        Sd = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
        step_p = jnp.linalg.solve(Sd, rhs.reshape(-1)).reshape(W, 6)
        step_p = step_p * free[:, None]
        if freeze_poses:
            step_p = step_p * 0.0
            step_l = jnp.einsum("lij,lj->li", Vinv, b_l,
                                precision="highest")
        elif freeze_landmarks:
            step_l = jnp.zeros_like(X)
        else:
            # back-substitute landmarks: dX = V^-1 (b_l - W' dp)
            Wt_dp = jnp.einsum("wlij,wi->lj", Wkj, step_p,
                               precision="highest")
            step_l = jnp.einsum("lij,lj->li", Vinv, b_l - Wt_dp,
                                precision="highest")

        new_poses = poses + step_p
        new_X = X + step_l
        new_cost = ba_cost(new_poses, new_X, obs, mask, calib,
                           pose_prior, prior_weight)
        # Levenberg-Marquardt trust-region control: accepted steps relax
        # the damping, rejected steps tighten it (a fixed damping would
        # recompute the identical rejected step forever).
        ok = jnp.isfinite(new_cost) & (new_cost < prev_cost)
        poses = jnp.where(ok, new_poses, poses)
        X = jnp.where(ok, new_X, X)
        cost = jnp.where(ok, new_cost, prev_cost)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9), lam * 10.0)
        return (poses, X, cost, lam), cost

    init_cost = ba_cost(poses0, X0, obs, mask, calib, pose_prior,
                        prior_weight)
    lam0 = jnp.asarray(damping, dtype)
    (poses, X, cost, _), _ = jax.lax.scan(
        iteration, (poses0, X0, init_cost, lam0), None, length=iters)
    return BAResult(poses=poses, landmarks=X, cost=cost,
                    initial_cost=init_cost,
                    iters=jnp.asarray(iters, jnp.int32))
