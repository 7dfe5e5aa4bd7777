"""Tensor-parallel descriptor matching (SURVEY.md P3).

The match-cost matrix is the reference's throughput kernel (3 calls/frame,
O(N1*N2) each — src/viso.cpp:1240,1264,1275).  For large keypoint budgets
(mono uses 1500 x 361-dim descriptors; dense variants go higher) one device's
memory and FLOPs bound the frame rate, so the matrix is sharded column-wise
over the mesh's 'model' axis:

  view-1 keypoints/descriptors  : replicated
  view-2 keypoints/descriptors  : sharded along slots
  (N1, N2/k) gated distances    : computed locally per device
  row-wise (best, 2nd, argmin)  : local reduce, then an all_gather of the
                                  k per-shard triples and a closed-form
                                  2-min merge — O(k*N1) exchanged instead of
                                  O(N1*N2) — then the ratio test.

The merge preserves EXACT unsharded argmin tie-breaking (lowest global
column index wins): shards are ordered, jnp.argmin picks the first of
equals both locally and across shards.  Tested for bit-equality against
match_descriptors on the 8-device CPU mesh (tests/test_tp_matching.py).
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from libviso_tpu.config import MatchConfig
from libviso_tpu.ops.features import Keypoints
from libviso_tpu.ops.matching import (
    MatchResult,
    finalize_match,
    gated_distance_matrix,
    two_smallest,
)


def merge_shard_minima(bests, seconds, idxs):
    """Merge per-shard (best, second, idx) row triples into global ones.

    Args:
      bests, seconds: (k, N1) per-shard row minima / runners-up.
      idxs: (k, N1) global column indices of the per-shard minima.

    Returns:
      (best, second, idx) each (N1,) — identical to a single-device
      two_smallest over the full matrix.
    """
    k = bests.shape[0]
    big = jnp.asarray(jnp.inf, dtype=bests.dtype)
    w = jnp.argmin(bests, axis=0)                       # (N1,) winner shard
    best = jnp.take_along_axis(bests, w[None, :], 0)[0]
    idx = jnp.take_along_axis(idxs, w[None, :], 0)[0]
    second_within = jnp.take_along_axis(seconds, w[None, :], 0)[0]
    masked = jnp.where(jnp.arange(k)[:, None] == w[None, :], big, bests)
    runner_across = jnp.min(masked, axis=0)
    second = jnp.minimum(second_within, runner_across)
    return best, second, idx


def build_tp_matcher(mesh: Mesh, cfg: MatchConfig = MatchConfig(),
                     use_F: bool = False,
                     axis: str = "model"):
    """Build a jittable tensor-parallel match function over `mesh`.

    Returns match(kp1, d1, kp2, d2[, F]) -> MatchResult with view-2 slots
    sharded over `axis` and everything else replicated.  N2 must divide by
    the axis size.  With axis size 1 this degenerates to the local matcher.
    """
    k = mesh.shape[axis]

    kp_spec = Keypoints(xy=P(axis), response=P(axis), valid=P(axis))
    in_specs = (Keypoints(xy=P(), response=P(), valid=P()), P(),
                kp_spec, P(axis))
    if use_F:
        in_specs = in_specs + (P(),)
    out_specs = MatchResult(idx=P(), dist=P(), valid=P())

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def match(kp1, d1, kp2_loc, d2_loc, *maybe_F):
        F = maybe_F[0] if use_F else None
        n2_loc = d2_loc.shape[0]
        dd = gated_distance_matrix(kp1, d1, kp2_loc, d2_loc, cfg, F=F)
        best, second, idx_loc = two_smallest(dd)
        offset = lax.axis_index(axis).astype(jnp.int32) * n2_loc
        idx_glob = idx_loc + offset

        bests = lax.all_gather(best, axis)        # (k, N1)
        seconds = lax.all_gather(second, axis)
        idxs = lax.all_gather(idx_glob, axis)
        gbest, gsecond, gidx = merge_shard_minima(bests, seconds, idxs)
        return finalize_match(gbest, gsecond, gidx, kp1.valid, cfg)

    return match


def tp_match_descriptors(mesh: Mesh, kp1: Keypoints, d1, kp2: Keypoints,
                         d2, cfg: MatchConfig = MatchConfig(), F=None,
                         axis: str = "model") -> MatchResult:
    """One-shot convenience wrapper around build_tp_matcher."""
    fn = build_tp_matcher(mesh, cfg, use_F=F is not None,
                          axis=axis)
    args = (kp1, d1, kp2, d2) + ((jnp.asarray(F),) if F is not None else ())
    return fn(*args)
