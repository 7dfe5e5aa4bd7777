"""Batched RANSAC pose estimation (SURVEY.md C11).

Fixed-shape re-design of reference ``ransac_minimize_reproj``
(src/viso.cpp:1543-1580): instead of 50 serial iterations, every hypothesis
is a lane of a vmapped Gauss-Newton solve — sample, iterate, and score all
models simultaneously.  Sampling replaces the reference's reservoir sampler
(src/viso.cpp:87-107) with a Gumbel-top-k draw over the validity mask
(statistically equivalent: a uniform random ``model_size``-subset of valid
points).  Semantics preserved:

  - each 3-point sample yields a model — by default a closed-form
    Horn-Kabsch alignment plus short polish (PARITY.md divergence #7);
    ``hypothesis_method='gn'`` restores the reference's GN fit from a
    zero initial motion,
  - the support set is every point with unweighted squared reprojection
    error < threshold^2 (src/viso.cpp:1525-1534),
  - the best model is refit on its whole support set and re-scored,
  - the estimate fails when the BEST hypothesis's support has < 6 points
    or the refit diverges — matching the reference, which checks the
    pre-refit support size (src/viso.cpp:1571-1573) and keeps the refit
    result regardless of how the re-scored support shrinks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.config import Calib, RansacConfig
from libviso_tpu.ops.topk import topk_auto
from libviso_tpu.solvers.gauss_newton import (
    gauss_newton,
    reprojection_errors_sq,
)


class RansacPoseResult(NamedTuple):
    tr: jax.Array            # (6,) best motion estimate
    inliers: jax.Array       # (N,) bool final support set
    num_inliers: jax.Array   # () int32
    ok: jax.Array            # () bool — reference's boolean return value
    best_hypothesis: jax.Array  # () int32 index (diagnostics)
    rms: jax.Array           # () reprojection RMS over the final support.
    #   The reference logs this per frame (src/viso.cpp:1577-1578) but its
    #   get_inliers OVERWRITES err2 each iteration instead of accumulating
    #   (viso.cpp:1526-1533), so it actually reports
    #   sqrt(last_point_err2 / N); we implement the evident intent
    #   (deliberate divergence, same class as PARITY.md #1).


def ransac_pose(key, X, observe, valid, calib: Calib,
                cfg: RansacConfig = RansacConfig()) -> RansacPoseResult:
    """Estimate the 6-dof motion from 3D-to-stereo correspondences.

    Args:
      key: PRNG key (replaces the reference's mt19937; parity is statistical,
        not bitwise — SURVEY.md §7 "PRNG parity").
      X: (N, 3) previous-frame 3D points (padded slots allowed).
      observe: (N, 4) current-frame stereo observations (u_l, v_l, u_r, v_r).
      valid: (N,) bool mask of real correspondences.
      calib, cfg: calibration / RANSAC configuration.
    """
    X = jnp.asarray(X)
    observe = jnp.asarray(observe)
    N = X.shape[0]
    H = cfg.num_hypotheses
    dtype = X.dtype

    # --- sample: H x model_size distinct valid indices (Gumbel top-k) ---
    gumbel = jax.random.gumbel(key, (H, N), dtype=dtype)
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = topk_auto(scores, cfg.model_size)  # (H, k)

    Xs = X[sample_idx]                  # (H, k, 3)
    obs_s = observe[sample_idx]         # (H, k, 4)
    if cfg.hypothesis_method == "procrustes":
        # --- fit: closed-form 3D-3D Kabsch alignment (the reference's
        # alternative estimator, estimation.cpp:29-51) between previous
        # points and the triangulated CURRENT points — Horn's quaternion
        # solve (squaring power iteration, no batched tiny-matrix
        # jnp.linalg.svd) instead of the fit
        # while_loop; degenerate (collinear) samples yield poor models
        # that the inlier scoring rejects.
        from libviso_tpu.geometry.procrustes import solve_rigid_motion_horn
        from libviso_tpu.geometry.se3 import matrix_to_pose_vector
        from libviso_tpu.geometry.triangulate import triangulate_rectified

        Xc = triangulate_rectified(observe, calib.f, calib.base, calib.cu,
                                   calib.cv)
        T = solve_rigid_motion_horn(Xc[sample_idx], Xs)  # T@Xprev~Xcur
        tr0 = matrix_to_pose_vector(T).astype(dtype)
        # Short GN polish from the closed-form init: the Kabsch solve
        # weights 3D (depth) error, which is noisy for distant points;
        # a few image-space steps restore reprojection-optimal
        # hypotheses at a fraction of the from-zero budget.  The cap is
        # RansacConfig.procrustes_polish_iters (3): measured identical
        # worst-case ATE to the former 8-step cap across every stress
        # regime — the vote only needs the support right; the refit
        # below carries the accuracy.
        w_s = jnp.ones((H, cfg.model_size), dtype=dtype)
        fit_cfg = dataclasses.replace(
            cfg, gn_iters=min(cfg.fit_gn_iters, cfg.gn_iters,
                              cfg.procrustes_polish_iters))
        fit = gauss_newton(Xs, obs_s, w_s, tr0, calib, fit_cfg)
        hyp_tr = fit.tr
        # a non-converged polish still carries a usable closed-form model
        hyp_converged = jnp.ones((H,), bool)
    else:
        # --- fit: vmapped GN on the gathered minimal sets ---
        # Capped iteration budget: the vmapped while_loop runs until the
        # slowest hypothesis lane finishes, so one degenerate sample would
        # pin all lanes at the full gn_iters (RansacConfig.fit_gn_iters).
        w_s = jnp.ones((H, cfg.model_size), dtype=dtype)
        tr0 = jnp.zeros((H, 6), dtype=dtype)
        fit_cfg = dataclasses.replace(cfg, gn_iters=min(cfg.fit_gn_iters,
                                                        cfg.gn_iters))
        fit = gauss_newton(Xs, obs_s, w_s, tr0, calib, fit_cfg)
        hyp_tr, hyp_converged = fit.tr, fit.converged

    # --- score: unweighted reprojection error of every point under every
    # hypothesis; one batched evaluation (H, N) ---
    err2 = reprojection_errors_sq(hyp_tr, X[None], observe[None], calib)
    thr2 = cfg.inlier_threshold**2
    inl = (err2 < thr2) & valid[None, :] & hyp_converged[:, None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)

    # --- refit on the best support set (masked weights, full point set) ---
    best_mask = inl[best]
    refit = gauss_newton(X, observe, best_mask.astype(dtype),
                         jnp.asarray(hyp_tr[best]), calib, cfg)
    err2_f = reprojection_errors_sq(refit.tr, X, observe, calib)
    final_mask = (err2_f < thr2) & valid
    n_final = jnp.sum(final_mask)

    ok = (jnp.sum(best_mask) >= cfg.min_inliers) & refit.converged
    rms = jnp.sqrt(jnp.sum(jnp.where(final_mask, err2_f, 0.0))
                   / jnp.maximum(n_final, 1))
    return RansacPoseResult(
        tr=refit.tr,
        inliers=final_mask,
        num_inliers=n_final,
        ok=ok,
        best_hypothesis=best,
        rms=rms.astype(dtype),
    )
