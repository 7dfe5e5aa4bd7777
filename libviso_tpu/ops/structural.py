"""Structural (3D-geometric) place recognition primitives.

Viewpoint-invariant revisit detection for loop closure.  The reference
has no loop closure at all (its trajectory is an open chain,
src/viso.cpp:1313-1321); round 1 added appearance-based detection over
Sobel-patch descriptors, whose measured capability boundary is ~25 deg
of heading change (docs/limitations.md "Loop-closure invariance" — at
180 deg the true cross-match count collapses below the alias floor).

This module closes that gap with geometry instead of appearance: every
keyframe already carries metrically-scaled triangulated 3D landmarks
(stereo gives absolute scale), and *pairwise distances between
landmarks are invariant under ANY rigid camera motion* — including a
180 deg heading flip that destroys patch appearance.  The design is
batched throughout: fixed-shape padded clouds, descriptor cost
matrices as matmuls, vmapped Procrustes RANSAC for verification.

Pipeline (mirrors the appearance path in pipeline/loop.py):

  1. per-landmark geometric descriptor = sorted distances to its k
     nearest co-visible landmarks (a 1D "shape context"; rigid-invariant
     by construction, degrades gracefully under partial co-visibility
     because nearby landmarks tend to be co-visible together);
  2. store-wide candidate scoring: one batched 2-NN ratio + mutual
     match of the new keyframe's descriptors against every stored
     keyframe — squared-L2 cost via the |a|^2+|b|^2-2ab expansion, so
     the (K, B, B) cost tensor is ONE batched matmul;
  3. seed pose from the matches with the existing 3D-3D Procrustes
     RANSAC (geometry/procrustes.py::ransac_rigid_motion — SURVEY.md
     C14, src/estimation.cpp:29-51 / src/viso.cpp:1101-1135);
  4. fixed-iteration 3D ICP refinement (radius-gated mutual nearest
     neighbors + weighted Kabsch re-solve) recovers the full co-visible
     support before the final reprojection certifier (same
     ``ransac_pose`` gate the appearance path uses).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from libviso_tpu.geometry.procrustes import solve_rigid_motion

_BIG = jnp.float32(1e30)


@functools.partial(jax.jit, static_argnames=("k", "max_depth"))
def knn_distance_descriptors(X, valid, k: int = 12,
                             max_depth: float = 60.0):
    """Per-landmark rigid-invariant descriptor: sorted k-NN distances.

    Args:
      X: (B, 3) triangulated landmarks in the keyframe's camera frame.
      valid: (B,) slot validity.
      k: neighbors per descriptor.
      max_depth: landmarks beyond this camera-frame depth are dropped —
        stereo depth noise grows ~z^2, so far points poison the metric
        distance profile.

    Returns:
      (desc (B, k) ascending neighbor distances, usable (B,) mask).
      Padded/invalid rows are all-zero with usable=False.
    """
    usable = valid & (X[:, 2] > 0.0) & (X[:, 2] <= max_depth)
    # pairwise squared distances via the matmul expansion
    n2 = jnp.sum(X * X, axis=-1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * (X @ X.T)
    d2 = jnp.maximum(d2, 0.0)
    pair_ok = usable[:, None] & usable[None, :]
    B = X.shape[0]
    d2 = jnp.where(pair_ok & ~jnp.eye(B, dtype=bool), d2, _BIG)
    # k smallest per row, ascending (top_k of -d2 is ascending in d2)
    neg_top, _ = jax.lax.top_k(-d2, k)
    desc = jnp.sqrt(jnp.maximum(-neg_top, 0.0))
    # a row needs k real neighbors for a comparable profile
    enough = jnp.sum(pair_ok, axis=-1) > k  # includes self
    usable = usable & enough
    desc = jnp.where(usable[:, None], desc, 0.0)
    return desc, usable


def build_structural_matcher(max_kf: int, budget: int, k: int,
                             ratio: float):
    """jit: new keyframe's geometric descriptors vs the whole store.

    Same contract as the appearance candidate matcher in
    pipeline/loop.py: per stored keyframe, a best-match index per query
    slot, a validity mask (2-NN ratio + mutual check), and a match-count
    score.  Cost is squared L2 over the sorted-distance descriptors —
    one (K*B, k) x (k, B) matmul.
    """

    def match_all(q_desc, q_valid, kf_desc, kf_valid):
        # cost[K, i, j] = |q_i - t_Kj|^2
        qn = jnp.sum(q_desc * q_desc, axis=-1)            # (B,)
        tn = jnp.sum(kf_desc * kf_desc, axis=-1)          # (K, B)
        cross = jnp.einsum("ik,Kjk->Kij", q_desc, kf_desc,
                           precision=jax.lax.Precision.HIGHEST)
        cost = qn[None, :, None] + tn[:, None, :] - 2.0 * cross
        cost = jnp.where(q_valid[None, :, None] & kf_valid[:, None, :],
                         jnp.maximum(cost, 0.0), _BIG)
        # 2 smallest per row -> Lowe ratio on SQUARED distances
        neg2, idx2 = jax.lax.top_k(-cost, 2)
        best, second = -neg2[..., 0], -neg2[..., 1]
        idx = idx2[..., 0]
        ok = (best < _BIG) & (best <= (ratio * ratio) * second)
        # mutual: the target's best query must be this query
        r_idx = jnp.argmin(cost, axis=1)                  # (K, B)
        mutual = (jnp.take_along_axis(r_idx, idx, axis=1)
                  == jnp.arange(budget)[None, :])
        vmatch = ok & mutual & q_valid[None, :]
        scores = jnp.sum(vmatch.astype(jnp.int32), axis=1)
        return idx, vmatch, scores

    return jax.jit(match_all)


def build_icp_refiner(radius: float, iters: int = 3):
    """jit: fixed-iteration 3D ICP from a seed pose.

    Each iteration transforms the old cloud by the current T, forms
    radius-gated MUTUAL nearest-neighbor pairs, and re-solves weighted
    Kabsch on them.  Fixed shapes, fixed iteration count — one jit
    graph.  Returns (T, old->new index map, pair mask, pair count).
    """

    def _nn_pairs(Xo, o_valid, Xn, n_valid):
        n2o = jnp.sum(Xo * Xo, axis=-1)
        n2n = jnp.sum(Xn * Xn, axis=-1)
        d2 = (n2o[:, None] + n2n[None, :]
              - 2.0 * (Xo @ Xn.T))
        d2 = jnp.where(o_valid[:, None] & n_valid[None, :],
                       jnp.maximum(d2, 0.0), _BIG)
        j = jnp.argmin(d2, axis=1)                        # old -> new
        i_back = jnp.argmin(d2, axis=0)                   # new -> old
        dmin = jnp.min(d2, axis=1)
        mutual = i_back[j] == jnp.arange(Xo.shape[0])
        ok = o_valid & mutual & (dmin <= radius * radius)
        return j, ok

    def refine(T0, X_old, o_valid, X_new, n_valid):
        def body(T, _):
            Xo = X_old @ T[:3, :3].T + T[:3, 3]
            j, ok = _nn_pairs(Xo, o_valid, X_new, n_valid)
            w = ok.astype(X_old.dtype)
            T_new = solve_rigid_motion(X_new[j], X_old, weights=w)
            # hold the pose if the support collapsed (degenerate solve)
            T_new = jnp.where(jnp.sum(w) >= 3, T_new, T)
            return T_new, None

        T, _ = jax.lax.scan(body, T0, None, length=iters)
        Xo = X_old @ T[:3, :3].T + T[:3, 3]
        j, ok = _nn_pairs(Xo, o_valid, X_new, n_valid)
        return T, j, ok, jnp.sum(ok.astype(jnp.int32))

    return jax.jit(refine)
