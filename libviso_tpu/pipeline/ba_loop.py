"""Composed back-end: sliding-window BA locally + pose-graph loop
closure globally (VERDICT r4 #3).

The reference has neither capability (its trajectory is an open chain,
src/viso.cpp:1313-1321); rounds 1-4 shipped them as mutually exclusive
CLI modes.  This driver composes them the way a full SLAM back-end
does:

  1. the windowed-BA driver (pipeline/windowed.py) runs the batched
     front-end over overlapping windows and refines each window's
     motions behind the r5 acceptance gate — LOCAL accuracy;
  2. at keyframe cadence, the SAME front-end outputs (TrackData rows)
     are summarized into compact keyframes and offered to the shared
     LoopEngine (pipeline/loop.py) — revisit detection + two-stage
     geometric verification, identical to the streaming loop driver
     because both feed ``summarize_keyframe`` the same per-frame slot
     arrays;
  3. after the last window, the pose graph over the BA-REFINED chain
     (sequential edges take their z from the refined trajectory, so
     local BA corrections survive) plus the verified loop edges
     redistributes the remaining drift — GLOBAL consistency.

Front-end work is shared: detection/matching for a frame runs once (in
its first covering window) and serves BA tracks and keyframe summaries
alike; no second pass over the images.

Checkpoint/resume: window progress, the keyframe store, and the
verified loop edges snapshot together (run_windowed_ba's
``extra_checkpoint`` hook) — resume is bit-exact because window RANSAC
keys are fold_in(key, w) and loop verification keys are
fold_in(key, 1_000_000 + t) on absolute indices, and keyframes are
offered before any snapshot that covers their window.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libviso_tpu.config import BAConfig, Calib, PipelineConfig
from libviso_tpu.pipeline.loop import (
    LoopEngine,
    close_graph,
    summarize_keyframe,
)
from libviso_tpu.pipeline.windowed import (
    WindowedResult,
    run_windowed_ba,
    window_starts,
)


@dataclasses.dataclass
class BALoopResult:
    poses: np.ndarray        # (T, 4, 4) BA + pose-graph trajectory
    poses_ba: np.ndarray     # (T, 4, 4) BA-refined open chain
    poses_vo: np.ndarray     # (T, 4, 4) front-end-only open chain
    motions: np.ndarray      # (T, 6) refined motions
    frame_ok: np.ndarray     # (T,)
    window_costs: list       # run_windowed_ba's 5-tuples
    loops: list              # [LoopEdge]
    graph_cost: tuple        # (initial, final) pose-graph cost
    loop_edge_scale: np.ndarray = None
    candidates: list = None
    processed: int = 0
    # store diagnostics (soak parity with LoopClosureResult)
    keyframes_offered: int = 0
    evictions: int = 0
    store_skipped: int = 0


class _EngineCheckpoint:
    """Adapter: LoopEngine state + offered-keyframe bookkeeping through
    run_windowed_ba's extra_checkpoint hook."""

    def __init__(self, engine, seen, starts, window, T, keyframe_every):
        self.engine = engine
        self.seen = seen
        self._starts = starts
        self._window = window
        self._T = T
        self._every = keyframe_every

    def leaves(self):
        return self.engine.state_leaves()

    def stats(self):
        return self.engine.loop_stats()

    def restore(self, leaves, stats, next_window):
        self.engine.restore(leaves, stats)
        # keyframes offered so far = keyframe-cadence frames inside the
        # span the restored windows cover
        covered = 0
        if next_window > 0:
            covered = min(self._starts[next_window - 1] + self._window,
                          self._T)
        self.seen.update(t for t in range(0, covered, self._every))


def run_windowed_ba_loop(frames, P1, P2,
                         cfg: PipelineConfig = PipelineConfig(),
                         ba: BAConfig = BAConfig(),
                         keyframe_every: int = 5, min_gap: int = 20,
                         min_matches: int = 60, min_inliers: int = 30,
                         max_keyframes: int = 128,
                         keyframe_budget: int = 256,
                         min_seed_inliers: int = 7,
                         guided_radius: float = 16.0,
                         loop_weight: float = 20.0,
                         verify_top_k: int = 3,
                         loop_match_ratio: float = 0.8,
                         robust: str = "cauchy",
                         robust_delta: float = 0.05,
                         normalize_desc: bool = True,
                         eviction: str = "spatial",
                         seed: int = 0,
                         checkpoint=None,
                         fingerprint_scope: str = "",
                         dbg_dir=None) -> BALoopResult:
    """Windowed BA + loop closure over a full sequence (composed mode).

    Args are the union of run_windowed_ba's BA knobs (via ``ba``) and
    run_with_loop_closure's loop knobs.  See the module docstring for
    the composition semantics.
    """
    import jax

    frames = list(frames)
    T = len(frames)
    calib = Calib.from_projections(P1, P2)
    window = ba.window
    stride = ba.stride
    starts = window_starts(T, window, stride)

    engine = LoopEngine(
        cfg, calib, jax.random.PRNGKey(seed),
        keyframe_every=keyframe_every, min_gap=min_gap,
        min_matches=min_matches, min_inliers=min_inliers,
        max_keyframes=max_keyframes, keyframe_budget=keyframe_budget,
        min_seed_inliers=min_seed_inliers, guided_radius=guided_radius,
        verify_top_k=verify_top_k, loop_match_ratio=loop_match_ratio,
        eviction=eviction)

    budget = engine.keyframe_budget
    desc_dim = cfg.detector.descriptor_dim
    summarize = jax.jit(lambda xy1, xy2, d, resp, usable, mi, X:
                        summarize_keyframe(xy1, xy2, d, resp, usable,
                                           mi, X, budget, desc_dim,
                                           normalize_desc))

    seen: set = set()

    from libviso_tpu.synthetic import _pose_matrix_np

    def _pos_at(t, motions, oks):
        """Trajectory position of frame t from the accumulated (refined)
        motions — host-side numpy chaining (no per-shape recompile)."""
        P = np.eye(4)
        if t > 0:
            Ts = _pose_matrix_np(np.stack(motions[1:t + 1]))
            for k_i, M in enumerate(Ts):
                if oks[1 + k_i]:
                    R, tt = M[:3, :3], M[:3, 3]
                    Minv = np.eye(4)
                    Minv[:3, :3] = R.T
                    Minv[:3, 3] = -R.T @ tt
                    P = P @ Minv
        return P[:3, 3].astype(np.float32)

    def on_window(w, s, e, tracks, motions, oks):
        for li in range(e - s):
            t = s + li
            if t % keyframe_every != 0 or t in seen:
                continue
            seen.add(t)
            usable = tracks.kp1_valid[li] & tracks.mlr_valid[li]
            xy, desc, obs, X, valid = summarize(
                tracks.kp1_xy[li], tracks.kp2_xy[li], tracks.d1[li],
                tracks.kp1_response[li], usable, tracks.mlr_idx[li],
                tracks.X[li])
            engine.offer(t, xy, desc, obs, X, valid,
                         lambda: _pos_at(t, motions, oks))

    extra = _EngineCheckpoint(engine, seen, starts, window, T,
                              keyframe_every)
    scope = (f"baloop:{keyframe_every}:{min_gap}:{min_matches}:"
             f"{min_inliers}:{max_keyframes}:{keyframe_budget}:"
             f"{loop_match_ratio}:{verify_top_k}:{min_seed_inliers}:"
             f"{guided_radius}:{robust}:{robust_delta}:"
             f"{normalize_desc}:{loop_weight}:{eviction}:"
             f"{fingerprint_scope}")
    res: WindowedResult = run_windowed_ba(
        frames, P1, P2, cfg, ba=ba, seed=seed,
        checkpoint=checkpoint, fingerprint_scope=scope,
        dbg_dir=dbg_dir, on_window=on_window, extra_checkpoint=extra)

    poses, graph_cost, loop_scale = close_graph(
        res.poses, engine.kf_frames, engine.loops,
        loop_weight=loop_weight, robust=robust,
        robust_delta=robust_delta)

    return BALoopResult(
        poses=poses, poses_ba=res.poses, poses_vo=res.poses_vo,
        motions=res.motions, frame_ok=res.frame_ok,
        window_costs=res.window_costs, loops=engine.loops,
        graph_cost=graph_cost, loop_edge_scale=loop_scale,
        candidates=engine.candidates, processed=res.processed,
        keyframes_offered=engine.n_kf, evictions=engine.evicted,
        store_skipped=engine.store_skipped)
