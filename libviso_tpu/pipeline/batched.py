"""Frame-batched stereo odometry (SURVEY.md P2).

The reference's frame loop is serial (src/viso.cpp:1205), but the only true
sequential dependency in stereo VO is the final pose chain — detection,
description, stereo matching, *and* the temporal matching between
consecutive frames are all independent computations once the image stack is
in memory.  This module processes a whole (T, H, W) window of frames as one
batched jit graph:

  - detect/describe: vmap over 2T images,
  - stereo matches + triangulation: vmap over T frames,
  - temporal matches/circle/RANSAC: vmap over the T-1 transitions
    (features of frame t matched against frame t-1 by offset slicing),
  - pose chain: associative scan (O(log T) depth).

This is the throughput mode (bench.py, sequence-sharded odometry); the
streaming mode in pipeline/stereo.py serves the online/latency case.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.config import Calib, PipelineConfig
from libviso_tpu.geometry.triangulate import triangulate_rectified
from libviso_tpu.ops.circle import circle_filter
from libviso_tpu.ops.features import detect_and_describe
from libviso_tpu.ops.matching import match_problem_batch
from libviso_tpu.solvers.ransac import ransac_pose


class BatchedOutput(NamedTuple):
    motions: jax.Array      # (T, 6): motion t-1 -> t; row 0 is zeros
    ok: jax.Array           # (T,) bool; row 0 False
    num_circle: jax.Array   # (T,) int32
    num_inliers: jax.Array  # (T,) int32
    num_lr: jax.Array       # (T,) int32


class TrackData(NamedTuple):
    """Front-end tensors needed to build BA windows (pipeline/refine.py)."""

    kp1_xy: jax.Array      # (T, N, 2)
    kp2_xy: jax.Array      # (T, N, 2)
    kp1_valid: jax.Array   # (T, N)
    kp2_valid: jax.Array   # (T, N)
    mlr_idx: jax.Array     # (T, N)
    mlr_valid: jax.Array   # (T, N)
    m11_idx: jax.Array     # (T-1, N) frame t+1 -> t left matches
    m11_valid: jax.Array   # (T-1, N)
    circ_valid: jax.Array  # (T-1, N) circle-consistent transitions
    X: jax.Array           # (T, N, 3) camera-local triangulations
    # left-view descriptors + Harris responses: the loop-closure
    # keyframe summary needs them when the batched front-end feeds the
    # composed BA+loop driver (pipeline/ba_loop.py)
    d1: jax.Array          # (T, N, D)
    kp1_response: jax.Array  # (T, N)


def build_batched_odometry(calib: Calib, F, cfg: PipelineConfig,
                           with_tracks: bool = False):
    """Build fn(ims1 (T,H,W), ims2 (T,H,W), key) -> BatchedOutput (jittable).

    ``with_tracks=True`` additionally returns a TrackData for windowed BA.
    """
    if cfg.keep_features_on_failure:
        # all frame pairs match in parallel here — holding a failed
        # frame's predecessor is inherently sequential state
        raise ValueError(
            "keep_features_on_failure is a streaming-step feature; the "
            "batched/DP/windowed drivers match all frame pairs in "
            "parallel and cannot hold state across a failure")
    F = jnp.asarray(F)
    n_slots = cfg.detector.num_slots

    def detect(im):
        return detect_and_describe(im, cfg.detector)

    stereo_cfg = cfg.stereo_match
    temporal_cfg = cfg.temporal_match

    def fn(ims1, ims2, key):
        from libviso_tpu.pipeline.stereo import match_layout

        T = ims1.shape[0]
        layout = match_layout(cfg, ims1.shape[-1])
        # all 2T detections as one vmapped batch
        kps, ds = jax.vmap(detect)(jnp.concatenate([ims1, ims2], axis=0))
        kp1 = jax.tree_util.tree_map(lambda x: x[:T], kps)
        kp2 = jax.tree_util.tree_map(lambda x: x[T:], kps)
        d1, d2 = ds[:T], ds[T:]

        # All window match problems as TWO homogeneous vmapped batches
        # (each batch shares radius/metric; Sampson/ratio gates are traced
        # per-problem flags): T stereo LR + 2(T-1) temporal problems in
        # two launches instead of 3T-2.
        fdt = d1.dtype
        mlr = match_problem_batch(
            kp1.xy, kp1.valid, d1, kp2.xy, kp2.valid, d2,
            use_epi=jnp.full((T,), stereo_cfg.use_epipolar),
            use_rat=jnp.full((T,), stereo_cfg.use_ratio),
            ratios=jnp.full((T,), stereo_cfg.ratio, fdt),
            radius=stereo_cfg.radius,
            sampson_thresh=stereo_cfg.sampson_thresh,
            metric=stereo_cfg.metric, F=F,
            layout=layout, image_width=ims1.shape[-1])

        Tm = 2 * (T - 1)
        tm = match_problem_batch(
            jnp.concatenate([kp1.xy[1:], kp2.xy[1:]]),
            jnp.concatenate([kp1.valid[1:], kp2.valid[1:]]),
            jnp.concatenate([d1[1:], d2[1:]]),
            jnp.concatenate([kp1.xy[:-1], kp2.xy[:-1]]),
            jnp.concatenate([kp1.valid[:-1], kp2.valid[:-1]]),
            jnp.concatenate([d1[:-1], d2[:-1]]),
            use_epi=jnp.zeros((Tm,), bool),
            use_rat=jnp.full((Tm,), temporal_cfg.use_ratio),
            ratios=jnp.full((Tm,), temporal_cfg.ratio, fdt),
            radius=temporal_cfg.radius,
            sampson_thresh=temporal_cfg.sampson_thresh,
            metric=temporal_cfg.metric, F=F,
            layout=layout, image_width=ims1.shape[-1])
        part = lambda tree, a, b: jax.tree_util.tree_map(
            lambda x: x[a:b], tree)
        m11 = part(tm, 0, T - 1)
        m22 = part(tm, T - 1, Tm)

        r_safe = jnp.clip(mlr.idx, 0, n_slots - 1)
        obs = jnp.concatenate(
            [kp1.xy, jnp.take_along_axis(kp2.xy, r_safe[..., None], axis=1)],
            axis=-1)  # (T, N, 4)
        X = triangulate_rectified(obs, calib.f, calib.base, calib.cu,
                                  calib.cv)

        circ = jax.vmap(circle_filter)(mlr.idx[1:], mlr.idx[:-1],
                                       m11.idx, m22.idx)

        lp_safe = jnp.clip(circ.left_prev, 0, n_slots - 1)
        Xp = jnp.take_along_axis(X[:-1], lp_safe[..., None], axis=1)
        prev_valid = jnp.take_along_axis(mlr.valid[:-1], lp_safe, axis=1)
        pts_valid = circ.valid & prev_valid & mlr.valid[1:]

        keys = jax.random.split(key, T - 1)
        est = jax.vmap(
            lambda k, Xp_t, obs_t, v_t: ransac_pose(
                k, Xp_t, obs_t, v_t, calib, cfg.ransac)
        )(keys, Xp, obs[1:], pts_valid)

        ok_t = est.ok & (circ.count >= cfg.min_circle_matches)
        tr_t = jnp.where(ok_t[:, None], est.tr, 0.0)

        zeros6 = jnp.zeros((1, 6), tr_t.dtype)
        out = BatchedOutput(
            motions=jnp.concatenate([zeros6, tr_t], axis=0),
            ok=jnp.concatenate([jnp.zeros((1,), bool), ok_t]),
            num_circle=jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), circ.count]),
            num_inliers=jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), est.num_inliers]),
            num_lr=jnp.sum(mlr.valid.astype(jnp.int32), axis=1),
        )
        if with_tracks:
            tracks = TrackData(
                kp1_xy=kp1.xy, kp2_xy=kp2.xy,
                kp1_valid=kp1.valid, kp2_valid=kp2.valid,
                mlr_idx=mlr.idx, mlr_valid=mlr.valid,
                m11_idx=m11.idx, m11_valid=m11.valid,
                circ_valid=circ.valid,
                X=X,
                d1=d1, kp1_response=kp1.response,
            )
            return out, tracks
        return out

    return fn
