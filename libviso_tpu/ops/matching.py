"""Dense gated descriptor matching (SURVEY.md C6).

The reference's ``match_desc`` (src/viso.cpp:668-726) is a per-keypoint
FLANN *linear* L1 radius search over keypoint positions followed by a scalar
scan over neighbors: Sampson epipolar gate, L1 descriptor distance,
best/2nd-best tracking, optional Lowe ratio test.  That control flow does
not batch; a brute-force masked (N1 x N2) score matrix does — it is a
dense, fixed-shape computation XLA fuses into a few kernels
(SURVEY.md §3.4).

Semantics preserved: a keypoint in view 1 matches its minimum-L1-descriptor
neighbor among view-2 keypoints within an L1 *position* radius
(cvflann::L1 over (x, y), radius 80), subject to the Sampson gate
(<= thresh, non-finite rejected) and the ratio test
(best < second_best * ratio).  Deliberate divergences (documented):
  - every in-radius candidate is scored — the reference truncates the FLANN
    neighbor list at max_neighbors=200/250 in index order
    (src/viso.cpp:62-74), an arbitrary subset when more are in range;
  - the reference's neighbor scan stops at the first index <= 0, which also
    drops keypoint 0 as a candidate (``nind>0`` at src/viso.cpp:692-693);
  - exact distance ties keep the first index (the reference keeps the last,
    src/viso.cpp:703).

Distances are plain jax.numpy: L1 as a chunked broadcast-reduce, L2 and
its int8 variant as matrix products plus norm terms.  Float32 products
run at ``_L2_PRECISION`` — see ``_l2_desc_dist``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.config import MatchConfig
from libviso_tpu.geometry.mvg import sampson_distance
from libviso_tpu.ops.features import Keypoints


class MatchResult(NamedTuple):
    """Per-slot matches: view-1 slot i -> view-2 slot ``idx[i]``."""

    idx: jax.Array    # (N1,) int32, -1 where unmatched
    dist: jax.Array   # (N1,) float, L1 descriptor distance (inf if none)
    valid: jax.Array  # (N1,) bool


def _l1_desc_dist_xla(d1, d2, row_chunk=128):
    """Chunked all-pairs L1 descriptor distance: (N1, D) x (N2, D) -> (N1, N2).

    Row-chunked so the (chunk, N2, D) broadcast stays small enough for XLA
    to fuse without an O(N1*N2*D) materialization.
    """
    import math

    N1 = d1.shape[0]
    # Largest divisor of N1 that fits: slot counts are powers of two in
    # practice, so this stays near the requested chunk; degenerate N1
    # degrades gracefully instead of asserting.
    row_chunk = math.gcd(N1, row_chunk) or 1

    def body(d1_block):
        return jnp.sum(jnp.abs(d1_block[:, None, :] - d2[None, :, :]), axis=-1)

    blocks = d1.reshape(N1 // row_chunk, row_chunk, d1.shape[1])
    return jax.lax.map(body, blocks).reshape(N1, d2.shape[0])


# Precision of the f32 cross term in the L2 identity.  Descriptors are
# raw Sobel values of magnitude ~1e3, so ||a||^2 + ||b||^2 - 2 a.b
# cancels terms of ~1e8 down to distances of ~1e5-1e6; a TF32 product
# (10-bit mantissa, the GPU's DEFAULT for f32) leaves errors of ~1e5
# there and reorders near-tied candidates.  HIGHEST keeps full f32.
_L2_PRECISION = jax.lax.Precision.HIGHEST


def _l2_desc_dist(d1, d2):
    """All-pairs (true) L2 distance via the matmul identity.

    ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b — the (N1, D) x (D, N2)
    contraction is one matrix product instead of an (N1, N2, D)
    broadcast.  Clamped at zero (cancellation can drive tiny distances
    slightly negative).
    """
    cross = jnp.dot(d1, d2.T, precision=_L2_PRECISION,
                    preferred_element_type=jnp.float32)
    n1 = jnp.sum(d1 * d1, axis=-1)
    n2 = jnp.sum(d2 * d2, axis=-1)
    sq = jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * cross, 0.0)
    # true L2 (not squared) so the Lowe ratio test keeps its usual scale
    return jnp.sqrt(sq)


def _l2q8_desc_dist(d1, d2, scale=8.0):
    """L2 distance over int8-QUANTIZED descriptors (int8 product).

    Sobel-patch descriptor values span ~[-1020, 1020] (ksize-3 Sobel of
    uint8 images, features.py); ``round(d/8)`` fits int8 with
    quantization noise ~sqrt(D)*scale/sqrt(12) ~ 25 per distance — two
    orders below typical non-match distances, and the Lowe ratio margin
    of true matches dwarfs it (equivalence tested).  The int8xint8 ->
    int32 contraction is exact integer arithmetic; norms and the
    unquantized SCALE factor are applied outside the hot contraction.
    """
    q1 = jnp.clip(jnp.round(d1 / scale), -127, 127).astype(jnp.int8)
    q2 = jnp.clip(jnp.round(d2 / scale), -127, 127).astype(jnp.int8)
    cross = jax.lax.dot_general(
        q1, q2, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)          # (N1, N2) int32
    n1 = jnp.sum(q1.astype(jnp.int32) ** 2, axis=-1)
    n2 = jnp.sum(q2.astype(jnp.int32) ** 2, axis=-1)
    sq = jnp.maximum(n1[:, None] + n2[None, :] - 2 * cross, 0)
    return scale * jnp.sqrt(sq.astype(d1.dtype))


def descriptor_distances(d1, d2, metric="l1"):
    """All-pairs descriptor distance matrix under the configured metric."""
    if metric == "l2":
        return _l2_desc_dist(d1, d2)
    if metric == "l2q8":
        return _l2q8_desc_dist(d1, d2)
    if metric != "l1":
        raise ValueError(f"unknown metric {metric!r}")
    return _l1_desc_dist_xla(d1, d2)


def gated_distance_matrix(kp1: Keypoints, d1, kp2: Keypoints, d2,
                          cfg: MatchConfig, F=None):
    """(N1, N2) descriptor-distance matrix with all gates applied (inf out).

    The position-radius, validity, and Sampson gates are per-pair, so this
    works identically on a column shard of view 2 — the TP matcher
    (parallel/tp_matching.py) calls it on local shards.
    """
    pos1 = kp1.xy
    pos2 = kp2.xy
    big = jnp.asarray(jnp.inf, dtype=d1.dtype)

    # Position gate: L1 radius on pixel coordinates (cvflann::L1, strict <).
    pos_l1 = (jnp.abs(pos1[:, None, 0] - pos2[None, :, 0])
              + jnp.abs(pos1[:, None, 1] - pos2[None, :, 1]))
    ok = pos_l1 < cfg.radius
    ok &= kp1.valid[:, None] & kp2.valid[None, :]

    if cfg.use_epipolar:
        if F is None:
            raise ValueError("epipolar gating requires F")
        s = sampson_distance(F, pos1[:, None, :], pos2[None, :, :])
        ok &= jnp.isfinite(s) & (s <= cfg.sampson_thresh)

    dd = descriptor_distances(d1, d2, metric=cfg.metric)
    return jnp.where(ok, dd, big)


def two_smallest(dd):
    """Row-wise (best, second_best, argmin) of a distance matrix."""
    big = jnp.asarray(jnp.inf, dtype=dd.dtype)
    best_idx = jnp.argmin(dd, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(dd, best_idx[:, None], axis=1)[:, 0]
    # Second best: mask the winner out, take the min of the rest.
    cols = jnp.arange(dd.shape[1], dtype=jnp.int32)
    dd2 = jnp.where(cols[None, :] == best_idx[:, None], big, dd)
    second = jnp.min(dd2, axis=1)
    return best, second, best_idx


def finalize_match(best, second, best_idx, kp1_valid,
                   cfg: MatchConfig) -> MatchResult:
    """Apply the ratio test + validity and build the MatchResult."""
    big = jnp.asarray(jnp.inf, dtype=best.dtype)
    valid = jnp.isfinite(best) & kp1_valid
    if cfg.use_ratio:
        valid &= best < second * cfg.ratio
    idx = jnp.where(valid, best_idx, -1)
    dist = jnp.where(valid, best, big)
    return MatchResult(idx=idx, dist=dist, valid=valid)


def _banded_tables_np(nbx, nby, k, band):
    """Static gather tables for the strip-banded matcher.

    The detect_harris_binned slot contract: slot (by*nbinx + bx)*k + j
    sits in x-strip bx (pixel span [bx*sx, (bx+1)*sx)).  Returns numpy
    (perm (nbx, P) strip-major slot ids, tidx (nbx, (2*band+1)*P)
    candidate slot ids per query strip, dup — True where an edge strip
    was clamp-duplicated and must be masked out).
    """
    import numpy as np

    per = nby * k
    # strip-major permutation of the n = nbx*per real slots
    perm = (np.arange(nby * nbx * k)
            .reshape(nby, nbx, k).transpose(1, 0, 2).reshape(nbx, per))
    offs = np.arange(-band, band + 1)
    g = np.arange(nbx)[:, None]
    h = np.clip(g + offs[None, :], 0, nbx - 1)        # (nbx, 2B+1)
    dup = (g + offs[None, :]) != h                    # clamped -> dup
    tidx = perm[h].reshape(nbx, (2 * band + 1) * per)
    dupm = np.repeat(dup, per, axis=1)
    return perm.astype(np.int32), tidx.astype(np.int32), dupm


def match_problem_batch(q_xy, q_valid, q_d, t_xy, t_valid, t_d,
                        use_epi, use_rat, ratios, radius, sampson_thresh,
                        metric, F,
                        layout=None, image_width=None) -> MatchResult:
    """A stack of B gated match problems as one vmapped computation.

    All problems share radius/metric/Sampson threshold; the Sampson and
    ratio gates are per-problem traced flags (``use_epi``/``use_rat``
    (B,) bool, ``ratios`` (B,)).  Inputs are (B, N, ...) stacks; returns a
    MatchResult of (B, N) tensors.  Used by match_frame_triple (B=3 per
    streaming frame) and the frame-batched pipeline (B=3T-2 per window).

    ``layout`` = (nbinx, nbiny, k, num_slots) + ``image_width`` enable
    the STRIP-BANDED fast path (round 4): keypoints from
    detect_harris_binned are x-strip-ordered, and the L1 position gate
    (< radius px) confines every query's candidates to
    ceil((radius+2)/sx) strips either side — the same static block
    sparsity the banded descriptor gather exploits.  The mask/argmin
    passes then run over (nbx, P, (2B+1)P) tensors ~5x smaller than
    (N, N) at KITTI scale.  Candidate coverage is EXACT (every pair the
    position gate admits is inside the band), so results match the
    dense path except where two candidates tie to the bit in distance
    (the band scans targets in strip-major order, the dense path in
    slot order; tested equal on real detector output).  'l1' keeps the
    dense path (its chunked broadcast-reduce doesn't profit from the
    narrower band the same way; strict-parity mode favors simplicity).
    """
    F = jnp.asarray(F)
    banded = None
    if layout is not None and metric != "l1":
        nbx, nby, k, n_slots = layout
        n = nbx * nby * k
        sx = image_width // nbx
        if sx >= 1 and n <= n_slots and q_xy.shape[1] == n_slots:
            band = -(-int(radius + 2) // sx)  # ceil
            if (2 * band + 1) < nbx:         # narrower than dense
                import numpy as np

                perm, tidx, dupm = _banded_tables_np(nbx, nby, k, band)
                banded = (jnp.asarray(perm), jnp.asarray(tidx),
                          jnp.asarray(dupm), n_slots)

    def one(qxy, qv, qd, txy, tv, td, epi, rat, ratio):
        big = jnp.asarray(jnp.inf, dtype=qd.dtype)
        if banded is not None:
            perm, tidx, dupm, n_slots = banded
            qxy_s = qxy[perm]                  # (nbx, P, 2)
            qv_s = qv[perm]
            qd_s = qd[perm]
            txy_b = txy[tidx]                  # (nbx, M, 2)
            tv_b = tv[tidx] & ~dupm
            td_b = td[tidx]
            pos_l1 = (jnp.abs(qxy_s[:, :, None, 0] - txy_b[:, None, :, 0])
                      + jnp.abs(qxy_s[:, :, None, 1]
                                - txy_b[:, None, :, 1]))
            ok = pos_l1 < radius
            ok &= qv_s[:, :, None] & tv_b[:, None, :]
            s = sampson_distance(F, qxy_s[:, :, None, :],
                                 txy_b[:, None, :, :])
            epi_ok = jnp.isfinite(s) & (s <= sampson_thresh)
            ok &= jnp.where(epi, epi_ok, True)
            if metric == "l2q8":
                q1 = jnp.clip(jnp.round(qd_s / 8.0), -127, 127
                              ).astype(jnp.int8)
                q2 = jnp.clip(jnp.round(td_b / 8.0), -127, 127
                              ).astype(jnp.int8)
                cross = jax.lax.dot_general(
                    q1, q2, (((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=jnp.int32)
                n1 = jnp.sum(q1.astype(jnp.int32) ** 2, axis=-1)
                n2 = jnp.sum(q2.astype(jnp.int32) ** 2, axis=-1)
                sq = jnp.maximum(n1[:, :, None] + n2[:, None, :]
                                 - 2 * cross, 0)
                dd = 8.0 * jnp.sqrt(sq.astype(qd.dtype))
            else:  # l2
                cross = jax.lax.dot_general(
                    qd_s, td_b, (((2,), (2,)), ((0,), (0,))),
                    precision=_L2_PRECISION,
                    preferred_element_type=jnp.float32)
                n1 = jnp.sum(qd_s * qd_s, axis=-1)
                n2 = jnp.sum(td_b * td_b, axis=-1)
                dd = jnp.sqrt(jnp.maximum(
                    n1[:, :, None] + n2[:, None, :] - 2.0 * cross, 0.0))
            dd = jnp.where(ok, dd, big)
            # row-wise best/second over the band (= over all admitted
            # candidates: coverage is exact)
            bl = jnp.argmin(dd, axis=2).astype(jnp.int32)
            best = jnp.take_along_axis(dd, bl[:, :, None], axis=2)[..., 0]
            cols = jnp.arange(dd.shape[2], dtype=jnp.int32)
            dd2 = jnp.where(cols[None, None, :] == bl[:, :, None], big, dd)
            second = jnp.min(dd2, axis=2)
            bidx = jnp.take_along_axis(tidx, bl, axis=1)  # global ids
            valid = jnp.isfinite(best) & qv_s
            valid &= jnp.where(rat, best < second * ratio, True)
            idxg = jnp.where(valid, bidx, -1)
            distg = jnp.where(valid, best, big)
            # scatter strip-major results back to slot order; the pad
            # tail (slots >= n) stays unmatched/invalid by construction
            flat = perm.reshape(-1)
            idx = jnp.full((n_slots,), -1, jnp.int32
                           ).at[flat].set(idxg.reshape(-1))
            dist = jnp.full((n_slots,), big
                            ).at[flat].set(distg.reshape(-1))
            vout = jnp.zeros((n_slots,), bool
                             ).at[flat].set(valid.reshape(-1))
            return MatchResult(idx=idx, dist=dist, valid=vout)
        pos_l1 = (jnp.abs(qxy[:, None, 0] - txy[None, :, 0])
                  + jnp.abs(qxy[:, None, 1] - txy[None, :, 1]))
        ok = pos_l1 < radius
        ok &= qv[:, None] & tv[None, :]
        s = sampson_distance(F, qxy[:, None, :], txy[None, :, :])
        epi_ok = jnp.isfinite(s) & (s <= sampson_thresh)
        ok &= jnp.where(epi, epi_ok, True)
        dd = descriptor_distances(qd, td, metric=metric)
        dd = jnp.where(ok, dd, big)
        best, second, bidx = two_smallest(dd)
        valid = jnp.isfinite(best) & qv
        valid &= jnp.where(rat, best < second * ratio, True)
        idx = jnp.where(valid, bidx, -1)
        dist = jnp.where(valid, best, big)
        return MatchResult(idx=idx, dist=dist, valid=valid)

    return jax.vmap(one)(q_xy, q_valid, q_d, t_xy, t_valid, t_d,
                         use_epi, use_rat, ratios)


def match_frame_triple(kp1: Keypoints, d1, kp2: Keypoints, d2,
                       kp1p: Keypoints, d1p, kp2p: Keypoints, d2p,
                       stereo: MatchConfig, temporal: MatchConfig,
                       F, layout=None, image_width=None):
    """The per-frame match workload as ONE vmapped 3-problem batch.

    The reference calls match_desc three times per frame — LR stereo
    (epipolar-gated), left-temporal and right-temporal (ratio-tested)
    (src/viso.cpp:1240,1264,1275).  The three (N, N) problems share shapes
    and radius, so they batch into a single (3, N, N) computation: one
    kernel launch instead of three, 3x the arithmetic intensity per
    dispatch.  Gates that differ per problem (Sampson, ratio) become traced
    per-problem flags.  Bit-identical to three match_descriptors calls
    (tested).

    Returns (match_lr, match_11, match_22).
    """
    if temporal.use_epipolar:
        # A constant F relates the two STEREO views; consecutive frames
        # are related by the unknown motion being estimated, so there is
        # no F to gate temporal matches with — the reference never does
        # (MatchParams defaults, viso.cpp:72-74).  The batched path would
        # otherwise silently drop the flag and the fallback path would
        # raise from match_descriptors; fail uniformly here.
        raise ValueError(
            "temporal_match.use_epipolar is unsupported: no fundamental "
            "matrix exists for unknown frame-to-frame motion")
    if (stereo.radius != temporal.radius
            or stereo.metric != temporal.metric):
        mlr = match_descriptors(kp1, d1, kp2, d2, stereo, F=F)
        m11 = match_descriptors(kp1, d1, kp1p, d1p, temporal)
        m22 = match_descriptors(kp2, d2, kp2p, d2p, temporal)
        return mlr, m11, m22

    res = match_problem_batch(
        q_xy=jnp.stack([kp1.xy, kp1.xy, kp2.xy]),
        q_valid=jnp.stack([kp1.valid, kp1.valid, kp2.valid]),
        q_d=jnp.stack([d1, d1, d2]),
        t_xy=jnp.stack([kp2.xy, kp1p.xy, kp2p.xy]),
        t_valid=jnp.stack([kp2.valid, kp1p.valid, kp2p.valid]),
        t_d=jnp.stack([d2, d1p, d2p]),
        use_epi=jnp.asarray([stereo.use_epipolar, False, False]),
        use_rat=jnp.asarray([stereo.use_ratio, temporal.use_ratio,
                             temporal.use_ratio]),
        ratios=jnp.asarray([stereo.ratio, temporal.ratio, temporal.ratio],
                           d1.dtype),
        radius=stereo.radius, sampson_thresh=stereo.sampson_thresh,
        metric=stereo.metric, F=F,
        layout=layout, image_width=image_width)
    pick = lambda i: jax.tree_util.tree_map(lambda x: x[i], res)
    return pick(0), pick(1), pick(2)


def match_descriptors(kp1: Keypoints, d1, kp2: Keypoints, d2,
                      cfg: MatchConfig = MatchConfig(),
                      F=None) -> MatchResult:
    """Match view-1 keypoints to view-2 keypoints (one match per slot).

    Args:
      kp1, kp2: fixed-size keypoint tensors.
      d1, d2: (N, D) descriptor tensors (zero rows on invalid slots).
      cfg: gates/thresholds; ``cfg.use_epipolar`` requires ``F``.
      F: (3, 3) fundamental matrix with x2' F x1 = 0 for x1 in view 1
        (the pipeline passes points as (p1=kp1, p2=kp2) exactly like the
        reference's sampsonDistance(F, p1, p2) call, src/viso.cpp:698).
    """
    dd = gated_distance_matrix(kp1, d1, kp2, d2, cfg, F=F)
    best, second, best_idx = two_smallest(dd)
    return finalize_match(best, second, best_idx, kp1.valid, cfg)
