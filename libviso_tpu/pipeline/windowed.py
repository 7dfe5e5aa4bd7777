"""Sequence-level sliding-window BA odometry (BASELINE config 4/5).

Drives the frame-batched front-end over a sequence in overlapping windows,
refines each window's motions with the Schur-complement BA, and stitches
the refined relative motions into a global trajectory.  Window w covers
frames [w*stride, w*stride + window); consecutive windows share
(window - stride) frames and the refined motions of the *later* window win
on the overlap (they are conditioned on more future evidence).

Distribution (config 5): windows are independent problems — the same
mapping used for sequence-chunk DP applies, with the landmark axis of each
BA additionally shardable over the 'model' mesh axis
(solvers/bundle_adjust.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.config import BAConfig, Calib, PipelineConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_tpu.pipeline.batched import build_batched_odometry
from libviso_tpu.pipeline.refine import (
    build_window_problem,
    refine_window_motions,
)


import functools


@functools.lru_cache(maxsize=8)
def _jitted_fns(calib: Calib, f_bytes: bytes, cfg: PipelineConfig,
                ba_iters: int, outlier_px: float,
                rerank_px: float, holdout_modulus: int,
                holdout_margin: float):
    """jit the three per-window programs ONCE per configuration.

    run_windowed_ba may be called repeatedly (multi-sequence runs, tests);
    fresh jax.jit closures per call would recompile the full front-end
    every time."""
    from libviso_tpu.pipeline.refine import motion_prior_poses

    F = np.frombuffer(f_bytes, np.float64).reshape(3, 3)
    n_slots = cfg.detector.num_slots
    fn = jax.jit(build_batched_odometry(calib, F, cfg,
                                        with_tracks=True))

    def _refine(prob, vo_motions, prior_motions, prior_count, prior_w6,
                vo_prior_w6):
        # prior poses compose from the overlap-prefix motions (current
        # VO motions fill the suffix, whose weight is zero); prior_count
        # is traced, so ONE compile serves every overlap length
        # including the no-prior case 0
        Wn = prob.poses0.shape[0]
        pose_prior = motion_prior_poses(vo_motions, prior_motions,
                                        prior_count)
        in_prefix = (jnp.arange(Wn) < prior_count).astype(
            prob.poses0.dtype)
        weight = in_prefix[:, None] * prior_w6[None, :]
        # VO-anchor shrinkage prior on ALL frames (r4 VERDICT #1): BA's
        # measured clean-run degradations come from pose motion along
        # reprojection-flat directions (the holdout ratio sits at ~0.95
        # while ATE doubles — benchmarks/world_ba_sweep_r4.jsonl); a
        # weak anchor at the VO poses pins those directions while the
        # data term overrides it wherever observations actually
        # disagree with VO (bad-stretch corrections survive).  Both
        # priors are diagonal quadratics, so they combine exactly:
        # weights add, anchors average weighted per dof.
        w_vo = jnp.broadcast_to(vo_prior_w6[None, :], weight.shape)
        w_comb = weight + w_vo
        anchor = jnp.where(w_comb > 0,
                           (weight * pose_prior + w_vo * prob.poses0)
                           / jnp.maximum(w_comb, 1e-20),
                           prob.poses0)
        pose_prior, weight = anchor, w_comb
        return refine_window_motions(prob, calib, iters=ba_iters,
                                     outlier_px=outlier_px,
                                     rerank_px=rerank_px,
                                     pose_prior=pose_prior,
                                     prior_weight=weight,
                                     holdout_modulus=holdout_modulus,
                                     holdout_margin=holdout_margin)

    refine = jax.jit(_refine)
    build = jax.jit(lambda tr, motions: build_window_problem(
        tr.kp1_xy, tr.kp2_xy, tr.mlr_idx, tr.mlr_valid,
        tr.m11_idx, tr.m11_valid, tr.X, motions, n_slots,
        circ_valid=tr.circ_valid))
    return fn, build, refine


def _dump_window_debug(dbg_dir, frames, s, lo, e, tracks):
    """Per-frame debug artifacts for the frames a window contributes.

    The windowed driver's analog of the streaming DebugDumper (C17):
    corners in both views, the stereo match blend, and the temporal
    stacked-match view, from the batched front-end's TrackData.  Local
    indices [lo, e-s) map to frames [s+lo, e) — overlap frames were
    already dumped by the previous window.
    """
    import os

    from libviso_tpu.utils import debug_viz as dv

    os.makedirs(dbg_dir, exist_ok=True)
    kp1 = np.asarray(tracks.kp1_xy)
    kp2 = np.asarray(tracks.kp2_xy)
    v1 = np.asarray(tracks.kp1_valid)
    v2 = np.asarray(tracks.kp2_valid)
    mlr_i = np.asarray(tracks.mlr_idx)
    mlr_v = np.asarray(tracks.mlr_valid)
    m11_i = np.asarray(tracks.m11_idx)
    m11_v = np.asarray(tracks.m11_valid)
    p = lambda name: os.path.join(dbg_dir, name)
    for li in range(lo, e - s):
        t = s + li
        im1 = np.asarray(frames[t][0])
        im2 = np.asarray(frames[t][1])
        dv.save_corners(im1, kp1[li], p(f"corners1_{t:03d}.jpg"),
                        valid=v1[li])
        dv.save_corners(im2, kp2[li], p(f"corners2_{t:03d}.jpg"),
                        valid=v2[li])
        dv.save_match_blend(im1, im2, kp1[li], kp2[li],
                            np.where(mlr_v[li], mlr_i[li], -1),
                            p(f"blend12_{t:03d}.jpg"))
        if li > 0:
            dv.save_stacked_matches(
                im1, np.asarray(frames[t - 1][0]), kp1[li], kp1[li - 1],
                np.where(m11_v[li - 1], m11_i[li - 1], -1),
                p(f"temporal_{t:03d}.jpg"))


def window_starts(T, window, stride):
    """Window start indices covering [0, T) (tail always covered)."""
    starts = list(range(0, max(T - window, 0) + 1, stride))
    if not starts:
        starts = [0]
    if starts[-1] + window < T:
        starts.append(T - window)
    return starts


@dataclasses.dataclass
class WindowedResult:
    poses: np.ndarray       # (T, 4, 4) BA-refined trajectory
    poses_vo: np.ndarray    # (T, 4, 4) front-end-only trajectory
    motions: np.ndarray     # (T, 6) refined motions
    frame_ok: np.ndarray    # (T,)
    # per-window 5-tuples (initial_cost, final_cost, accepted,
    # holdout_half0, holdout_half1); `accepted` is gate-inclusive —
    # solver ok AND (gate off or holdout_gate accepted)
    window_costs: list
    processed: int = 0      # frames computed THIS run (excludes
    #                         checkpoint-restored windows)


def run_windowed_ba(frames, P1, P2, cfg: PipelineConfig = PipelineConfig(),
                    ba: BAConfig = BAConfig(),
                    window: int = None, stride: int = None,
                    ba_iters: int = None,
                    seed: int = 0,
                    checkpoint=None,
                    fingerprint_scope: str = "",
                    outlier_px: float = None, rerank_px: float = None,
                    prior_strength: float = None,
                    vo_prior_strength: float = None,
                    min_cam_obs: int = None,
                    gate: bool = None,
                    holdout_modulus: int = None,
                    gate_margin: float = None,
                    dbg_dir=None,
                    on_window=None,
                    extra_checkpoint=None) -> WindowedResult:
    """Stereo VO + sliding-window BA over a full sequence.

    Args:
      frames: list of (left, right) image pairs (host arrays).
      ba: BAConfig carrying every BA knob (VERDICT r3 #8).  The explicit
        keyword arguments below override individual fields when not None
        (back-compat surface; new call sites should pass ``ba``).
      window: frames per BA window.
      stride: window start spacing (stride < window = overlap).
      checkpoint: optional utils.checkpoint.CheckpointManager; progress is
        snapshotted every ``checkpoint.every`` completed WINDOWS and a run
        resumes after the last one (per-window keys are fold_in(key, w),
        so resume is bit-exact).  Fingerprint covers cfg/window/stride/
        ba_iters/seed/prior + ``fingerprint_scope``.
      outlier_px, rerank_px: the two-stage BA observation gates
        (pipeline/refine.py) — config-lifted per VERDICT r1 weak #4.
      prior_strength: scale of the cross-window marginalization prior
        (VERDICT r1 next #5).  Window w's overlap-prefix motions carry a
        quadratic prior anchored at window w-1's REFINED estimates, so
        information flows across the seam instead of the later window
        silently overwriting the earlier one's conditioning.  1.0 ~=
        a third of a typical window's own information about a boundary
        pose; 0 disables (round-1
        later-window-wins behavior).
      gate, holdout_modulus, gate_margin: per-window acceptance gate
        (VERDICT r3 #6, recalibrated r5 — pipeline/refine.py::
        holdout_gate): a window's refined motions are applied only when
        they predict the gate observations CLEARLY better (paired
        error ratio vs the VO poses, MEAN over the parity halves
        <= margin) — rejected windows fall back to VO wholesale.
        Measured contract (48 rows): cuts worse-than-VO rows 11 -> 4
        and mean harm 2.6x vs ungated BA while keeping ~73% of its net
        win; NOT a never-worse guarantee (see holdout_gate).
        ``holdout_modulus`` 0 gates on all masked observations; m>1
        holds every m-th landmark out of BA and gates on those.
      on_window: optional callback ``(w, s, e, tracks, motions, oks)``
        invoked after window w's motions are stitched (the composed
        BA+loop driver summarizes keyframes from ``tracks`` here —
        pipeline/ba_loop.py).  ``motions``/``oks`` are live views of
        the accumulating arrays.
      extra_checkpoint: optional object with ``leaves()``, ``stats()``,
        and ``restore(leaves, stats, next_window)`` — additional state
        snapshotted/restored alongside the window progress (the loop
        engine's keyframe store).  Changes the snapshot layout, so it
        participates in the fingerprint scope (callers add a mode tag).
    """
    if window is None:
        window = ba.window
    if stride is None:
        stride = ba.stride
    if ba_iters is None:
        ba_iters = ba.iters
    if outlier_px is None:
        outlier_px = ba.outlier_px
    if rerank_px is None:
        rerank_px = ba.rerank_px
    if prior_strength is None:
        prior_strength = ba.prior_strength
    if vo_prior_strength is None:
        vo_prior_strength = ba.vo_prior_strength
    if min_cam_obs is None:
        min_cam_obs = ba.min_cam_obs
    if gate is None:
        gate = ba.gate
    if holdout_modulus is None:
        holdout_modulus = ba.holdout_modulus
    if gate_margin is None:
        gate_margin = ba.gate_margin
    if stride > window:
        # starts would advance past window ends, leaving periodic frame
        # gaps whose motions stay zero-initialized — a silently corrupt
        # trajectory reported as success
        raise ValueError(
            f"stride ({stride}) must be <= window ({window}): larger "
            "strides leave frames covered by no BA window")
    frames = list(frames)
    T = len(frames)
    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    fn, build, refine = _jitted_fns(
        calib, np.ascontiguousarray(F, np.float64).tobytes(), cfg,
        ba_iters, float(outlier_px), float(rerank_px),
        int(holdout_modulus), float(gate_margin))
    # per-dof prior information, px^2 per unit^2: a rotation dof moves a
    # pixel by ~f px/rad, a translation dof by ~f/Z px/m (Z ~ 15 m
    # typical landmark depth) — scaled to ~1/3 of the ~200-observation
    # info a window itself has about a boundary pose
    f2 = calib.f * calib.f
    unit_w6 = np.array(
        [70.0 * f2, 70.0 * f2, 70.0 * f2,
         70.0 * f2 / 225.0, 70.0 * f2 / 225.0, 70.0 * f2 / 225.0],
        np.float32)
    prior_w6 = prior_strength * unit_w6
    vo_prior_w6 = vo_prior_strength * unit_w6

    # Ship each frame to the device once per residency (uint8 stays
    # uint8 — 4x less host-to-device traffic; the detector casts
    # on-device).  Overlapping windows stack device-resident frames
    # instead of re-uploading the (window - stride)-frame overlap each
    # time.  The cache holds only the live window span (windows are
    # processed in increasing start order), so device memory stays
    # O(window), not O(sequence), and checkpoint-resumed runs upload
    # nothing for already-covered windows.
    dev_cache = {}

    def window_stacks(s, e):
        for i in list(dev_cache):
            if i < s:
                del dev_cache[i]
        for i in range(s, e):
            if i not in dev_cache:
                dev_cache[i] = (
                    jax.device_put(jnp.asarray(np.asarray(frames[i][0]))),
                    jax.device_put(jnp.asarray(np.asarray(frames[i][1]))))
        return (jnp.stack([dev_cache[i][0] for i in range(s, e)]),
                jnp.stack([dev_cache[i][1] for i in range(s, e)]))

    key = jax.random.PRNGKey(seed)
    motions = np.zeros((T, 6), np.float32)
    oks = np.zeros((T,), bool)
    motions_vo = np.zeros((T, 6), np.float32)
    window_costs = []

    starts = window_starts(T, window, stride)

    w0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_tpu.utils.checkpoint import (
            Checkpoint,
            config_fingerprint,
        )

        fingerprint = config_fingerprint(
            cfg, seed,
            scope=f"ba:{window}:{stride}:{ba_iters}:T{T}:"
                  f"p{prior_strength}:v{vo_prior_strength}:"
                  f"o{outlier_px}:r{rerank_px}:"
                  f"c{min_cam_obs}:g{int(gate)}h{holdout_modulus}"
                  f"x{gate_margin}:{fingerprint_scope}")
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch (different cfg/"
                    f"window/stride/seed/sequence/scope): "
                    f"{ck.fingerprint} != {fingerprint}")
            if len(ck.motions) != T:  # belt and braces vs the T in scope
                raise ValueError(
                    f"checkpoint covers {len(ck.motions)} frames but the "
                    f"run has {T}; resume with the same frame list")
            w0 = ck.next_frame            # next WINDOW index here
            motions = np.array(ck.motions, np.float32)
            oks = np.array(ck.oks, bool)
            motions_vo = np.array(ck.state_leaves[0], np.float32)
            if extra_checkpoint is not None:
                window_costs = [tuple(c) for c in ck.stats[0]]
                extra_checkpoint.restore(ck.state_leaves[1:],
                                         ck.stats[1], w0)
            else:
                window_costs = [tuple(c) for c in ck.stats]

    def _snapshot(next_window):
        from libviso_tpu.utils.checkpoint import Checkpoint

        wc = [list(c) for c in window_costs]
        checkpoint.save(Checkpoint(
            next_frame=next_window,
            motions=motions.astype(np.float64),
            oks=oks,
            state_leaves=([motions_vo] + extra_checkpoint.leaves()
                          if extra_checkpoint is not None
                          else [motions_vo]),
            stats=([wc, extra_checkpoint.stats()]
                   if extra_checkpoint is not None else wc),
            fingerprint=fingerprint,
        ))

    for w, s in enumerate(starts):
        if w < w0:  # restored from checkpoint
            continue
        e = min(s + window, T)
        ims1, ims2 = window_stacks(s, e)
        out, tracks = fn(ims1, ims2, jax.random.fold_in(key, w))
        prob = build(tracks, out.motions)
        # marginalization prior: anchor this window's overlap-prefix
        # motions at the PREVIOUS window's refined estimates (already in
        # `motions`); local index i <-> frame s+i, prefix length =
        # previous window's end minus s.  First window: count 0.
        if w > 0:
            prev_e = min(starts[w - 1] + window, T)
            overlap = max(0, min(prev_e - s, e - s))
        else:
            overlap = 0
        prior_count = overlap if prior_strength > 0 else 0
        prior_motions = jnp.asarray(motions[s:e])
        if dbg_dir is not None:
            _dump_window_debug(dbg_dir, frames, s, overlap, e, tracks)
        ref = refine(prob, out.motions, prior_motions,
                     jnp.asarray(prior_count, jnp.int32),
                     jnp.asarray(prior_w6), jnp.asarray(vo_prior_w6))
        refined = np.asarray(ref.motions)
        out_ok = np.asarray(out.ok)
        # a motion is BA-trustworthy only when the window converged AND
        # the held-out landmark gate accepted the refined poses (clear
        # win over VO on tracks BA never saw — pipeline/refine.py) AND
        # both endpoint cameras kept enough post-gate observations —
        # a weakly-observed camera's refined motion can be meters off
        # while the window cost still drops (pipeline/refine.py)
        cam_obs = np.asarray(ref.cam_obs)
        cam_ok = cam_obs >= min_cam_obs
        accepted = bool(ref.ok) & (not gate or bool(ref.holdout_ok))
        motion_ok = accepted & cam_ok & np.roll(cam_ok, 1)
        motion_ok[0] = False
        use = np.where(motion_ok[:, None], refined,
                       np.asarray(out.motions))
        window_costs.append((float(ref.initial_cost), float(ref.cost),
                             accepted, float(ref.holdout_half0),
                             float(ref.holdout_half1)))
        # local index 0 is the window's halo frame (no motion)
        motions[s + 1:e] = use[1:]
        motions_vo[s + 1:e] = np.asarray(out.motions)[1:]
        # BA convergence vouches only for the frames whose motions it
        # actually REPLACED (motion_ok): a frame that fell back to its
        # VO motion keeps its VO ok flag — marking it ok while applying
        # a motion the VO itself flagged as failed (zeroed) would chain
        # a bogus step into the trajectory.  `constrained` additionally
        # requires the front-end to have observed the frame at all.
        constrained = np.asarray(out.num_circle)[1:] >= cfg.min_circle_matches
        oks[s + 1:e] = out_ok[1:] | (motion_ok[1:] & constrained)
        if on_window is not None:
            # AFTER stitching, BEFORE the snapshot: the composed driver
            # must offer this window's keyframes before any checkpoint
            # that claims window w is done (a snapshot between would
            # resume without them and diverge)
            on_window(w, s, e, tracks, motions, oks)
        if checkpoint is not None and (w + 1) % checkpoint.every == 0:
            _snapshot(w + 1)

    if checkpoint is not None and window_costs:
        _snapshot(len(starts))

    oks[0] = False
    Ts = pose_vector_to_matrix(jnp.asarray(motions))
    poses = np.asarray(chain_motions(Ts, jnp.asarray(oks)))
    Ts_vo = pose_vector_to_matrix(jnp.asarray(motions_vo))
    poses_vo = np.asarray(chain_motions(Ts_vo, jnp.asarray(oks)))
    processed = 0 if w0 >= len(starts) else T - starts[w0]
    return WindowedResult(poses=poses, poses_vo=poses_vo, motions=motions,
                          frame_ok=oks, window_costs=window_costs,
                          processed=processed)
