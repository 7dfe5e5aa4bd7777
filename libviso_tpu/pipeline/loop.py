"""Loop closure: revisit detection + pose-graph drift removal.

Beyond-reference capability (the reference's trajectory is a pure open
chain, src/viso.cpp:1313-1321; its drift is unbounded).  The design
reuses the engine's existing batched primitives end to end:

  1. every ``keyframe_every``-th frame, the streaming step's FrameState
     is summarized to a compact keyframe: the ``keyframe_budget``
     highest-response corners' descriptors, stereo observations, and
     triangulated 3D (one small jit, device-side top-k);
  2. each new keyframe matches against ALL stored keyframes as ONE
     `match_problem_batch` launch (position gate off — drift makes
     positions useless across a loop; the appearance ratio test does the
     work).  Candidates need ``min_matches`` ratio-passing matches and
     ``min_gap`` frames of separation;
  3. a candidate is verified by the SAME RANSAC+GN pose solver the
     per-frame step uses, on the old keyframe's 3D against the new
     keyframe's stereo observations — a verified revisit yields the
     relative pose T_new^-1 T_old;
  4. the sequential VO motions plus every verified loop edge form a pose
     graph; `solvers/pose_graph.py` redistributes the drift.

Fixed shapes: the keyframe store is a preallocated (max_keyframes, ...)
slot tensor with a validity mask, so the candidate-matching launch never
recompiles as the store grows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.config import Calib, PipelineConfig
from libviso_tpu.geometry.se3 import (
    invert_se3,
    matrix_to_pose_vector,
    pose_vector_to_matrix,
)
from libviso_tpu.ops.features import Keypoints
from libviso_tpu.solvers.pose_graph import (
    optimize_pose_graph,
    reanchor_segments,
)
from libviso_tpu.solvers.ransac import ransac_pose


class LoopEdge(NamedTuple):
    frame_new: int        # later frame (the revisit)
    frame_old: int        # earlier frame being re-observed
    tr: np.ndarray        # (6,) motion old -> new (ransac convention)
    num_inliers: int
    num_matches: int


@dataclasses.dataclass
class LoopClosureResult:
    poses: np.ndarray       # (T, 4, 4) pose-graph-optimized trajectory
    poses_vo: np.ndarray    # (T, 4, 4) open-chain VO trajectory
    motions: np.ndarray     # (T, 6) VO motions
    frame_ok: np.ndarray    # (T,)
    loops: list             # [LoopEdge]
    graph_cost: tuple       # (initial, final) pose-graph cost
    # final robust IRLS scale per loop edge (aligned with `loops`): ~1 =
    # believed, ~0 = disbelieved by the Cauchy kernel (a false revisit)
    loop_edge_scale: np.ndarray = None
    # per-verification-attempt diagnostics:
    # {frame_new, frame_old, score, ok, num_inliers} — every candidate
    # that reached geometric verification, accepted or not (the loop
    # analog of the per-frame stats dict; drives threshold tuning)
    candidates: list = None
    # frames computed THIS run (excludes checkpoint-restored frames) —
    # drivers report fps over this, not the restored span
    processed: int = 0
    # store diagnostics (r5 soak): keyframes offered over the run, and
    # spatial-eviction activity once the store is full
    keyframes_offered: int = 0
    evictions: int = 0
    store_skipped: int = 0


def summarize_keyframe(xy1, xy2, desc_all, response, usable, mlr_idx,
                       X_all, budget: int, desc_dim: int,
                       normalize: bool):
    """Compact-keyframe summary from per-frame slot arrays.

    Front-end-agnostic core (r5): the streaming driver feeds FrameState
    fields (``_build_summarize``), the composed BA+loop driver feeds
    TrackData rows (pipeline/ba_loop.py) — both produce bitwise the
    same keyframe for the same frame.

    ``normalize`` re-signs the stored descriptors as zero-mean unit-L2
    vectors over their REAL dims (the 121->128 pad stays zero): Sobel
    responses are already bias-free, so unit-norm adds the missing GAIN
    invariance — revisit detection then survives exposure/illumination
    change between visits (VERDICT r1 #4b), which raw patch distances
    do not (a 1.3x gain scales every L1 distance by 1.3x and breaks the
    cross-keyframe score comparison).
    """
    score = jnp.where(usable, response, -jnp.inf)
    _, top = jax.lax.top_k(score, budget)
    valid = jnp.take_along_axis(usable, top, axis=0)
    desc = desc_all[top]
    if normalize:
        d = desc[:, :desc_dim]
        d = d - d.mean(axis=-1, keepdims=True)
        d = d / jnp.maximum(
            jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
        # uniform rescale: invariant for L1/L2 match semantics (the
        # ratio test is scale-free) but REQUIRED for the l2q8 metric,
        # whose int8 quantization step (round(d/8)) maps unit-norm
        # values (~±0.1) to all-zero descriptors otherwise
        desc = jnp.zeros_like(desc).at[:, :desc_dim].set(d * 1024.0)
    r_safe = jnp.clip(mlr_idx[top], 0, xy2.shape[0] - 1)
    obs = jnp.concatenate([xy1[top], xy2[r_safe]], axis=-1)
    return xy1[top], desc, obs, X_all[top], valid


def _build_summarize(budget: int, desc_dim: int, normalize: bool):
    """jit: FrameState -> compact keyframe (see summarize_keyframe)."""

    def summarize(state):
        # usable slots: detected, stereo-matched, triangulated
        usable = state.kp1.valid & state.X_valid
        return summarize_keyframe(
            state.kp1.xy, state.kp2.xy, state.d1, state.kp1.response,
            usable, state.match_lr, state.X, budget, desc_dim, normalize)

    return jax.jit(summarize)


def _build_candidate_matcher(cfg: PipelineConfig, max_kf: int,
                             budget: int, ratio: float):
    """jit: new keyframe vs the whole store as one batched launch.

    ``ratio`` is deliberately STRICTER than the temporal matcher's (0.8
    vs 0.9 by default): cross-loop matching has no position gate, so the
    candidate pool is the full store and the aliased-match floor scales
    with it — the tighter Lowe ratio suppresses aliases while true
    revisit matches (distinct margins on band-limited texture) survive.
    """
    from libviso_tpu.ops.matching import match_problem_batch

    d = cfg.detector.descriptor_dim_padded

    def match_all(q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid):
        K = max_kf
        f32 = q_desc.dtype
        res = match_problem_batch(
            q_xy=jnp.broadcast_to(q_xy, (K, budget, 2)),
            q_valid=jnp.broadcast_to(q_valid, (K, budget)),
            q_d=jnp.broadcast_to(q_desc, (K, budget, d)),
            t_xy=kf_xy, t_valid=kf_valid, t_d=kf_desc,
            use_epi=jnp.zeros((K,), bool),
            use_rat=jnp.ones((K,), bool),
            ratios=jnp.full((K,), ratio, f32),
            radius=1e9,   # drift makes positions meaningless across loops
            sampson_thresh=1.0, metric=cfg.temporal_match.metric,
            F=jnp.eye(3, dtype=f32))
        scores = jnp.sum(res.valid.astype(jnp.int32), axis=1)  # (K,)
        return res.idx, res.valid, scores

    return jax.jit(match_all)


def _build_guided_matcher(cfg: PipelineConfig, budget: int,
                          calib: Calib, radius: float):
    """jit: guided re-match of an old keyframe against a new one UNDER a
    candidate relative pose.

    Blind appearance matching across a loop yields barely-minimal
    verified support (the alias floor crowds the ratio test); once a
    candidate pose exists, projecting the old keyframe's landmarks into
    the new view turns the problem back into a RADIUS-GATED match — the
    same geometry gate the temporal matcher enjoys — which recovers the
    full co-visible support and lets the final solve run on 3-4x the
    inliers.  Standard two-stage loop verification, built entirely from
    the engine's existing batched matcher.
    """
    from libviso_tpu.ops.matching import match_descriptors

    def guided(tr, X_old, d_old, v_old, kp_new_xy, d_new, v_new):
        T = pose_vector_to_matrix(tr)
        Xn = X_old @ T[:3, :3].T + T[:3, 3]
        z = jnp.maximum(Xn[:, 2], 1e-3)
        proj = jnp.stack([calib.f * Xn[:, 0] / z + calib.cu,
                          calib.f * Xn[:, 1] / z + calib.cv], axis=-1)
        q_valid = v_old & (Xn[:, 2] > 0.1)
        kq = Keypoints(xy=proj, response=jnp.zeros((budget,), proj.dtype),
                       valid=q_valid)
        kt = Keypoints(xy=kp_new_xy,
                       response=jnp.zeros((budget,), proj.dtype),
                       valid=v_new)
        mc = dataclasses.replace(cfg.temporal_match, radius=radius,
                                 use_epipolar=False, use_ratio=False)
        res = match_descriptors(kq, d_old, kt, d_new, mc,
                                F=jnp.eye(3, dtype=proj.dtype))
        return res.idx, res.valid, res.dist

    return jax.jit(guided)


def _spatial_evict_slot(pos_stored, frames_stored, pos_new):
    """Pick the store slot to overwrite so the keyframe set stays a
    COVERAGE of the trajectory (VERDICT r3 #4).

    A FIFO ring silently evicts exactly the keyframes long loops need:
    on a KITTI-00-scale run (~900 keyframes through a 128-slot ring)
    the loop-opening keyframes are gone by revisit time.  Instead,
    evict the most REDUNDANT keyframe: among the closest pair of stored
    positions (the new keyframe participates as a candidate too), drop
    the NEWER member — older keyframes are the anchors revisits close
    against, and the surviving member of the pair preserves local
    coverage.  Positions come from the drifted VO chain, which is fine:
    redundancy is judged between (mostly temporally close) neighbors,
    where relative VO error is small.

    Returns the slot index to overwrite, or -1 to skip storing the new
    keyframe (it was itself the redundant one).
    """
    pos = np.concatenate([pos_stored, pos_new[None]], axis=0)
    fr = np.concatenate([frames_stored, [np.iinfo(np.int64).max]])
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    i, j = np.unravel_index(np.argmin(d2), d2.shape)
    victim = i if fr[i] > fr[j] else j
    return -1 if victim == len(pos_stored) else int(victim)


class LoopEngine:
    """Keyframe store + revisit detection + geometric verification,
    decoupled from the front-end that produces keyframe summaries.

    Extracted from the streaming driver (r5) so the SAME store,
    candidate matcher, two-stage guided verification, and spatial
    eviction serve both front-ends: the streaming per-frame step
    (``run_with_loop_closure`` summarizes its FrameState) and the
    windowed-BA batched front-end (``pipeline/ba_loop.py`` summarizes
    TrackData rows) — the composition VERDICT r4 #3 asked for.

    The engine is host-driven mutable state around three jitted
    programs; keys for the verification solves derive from the caller's
    base key exactly as the streaming driver always did
    (``fold_in(key, 1_000_000 + t)`` / ``2_000_000 + 2t + it``), so
    refactoring changed no draw.
    """

    def __init__(self, cfg: PipelineConfig, calib: Calib, key, *,
                 keyframe_every=5, min_gap=20, min_matches=60,
                 min_inliers=30, max_keyframes=128, keyframe_budget=256,
                 min_seed_inliers=7, guided_radius=16.0,
                 verify_top_k=3, loop_match_ratio=0.8,
                 eviction="spatial"):
        if eviction not in ("spatial", "fifo"):
            raise ValueError(f"eviction must be 'spatial' or 'fifo', "
                             f"got {eviction!r}")
        # a budget larger than the slot tensor is a no-op, not an error
        keyframe_budget = min(keyframe_budget, cfg.detector.num_slots)
        self.cfg = cfg
        self.calib = calib
        self.key = key
        self.keyframe_every = keyframe_every
        self.min_gap = min_gap
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.max_keyframes = max_keyframes
        self.keyframe_budget = keyframe_budget
        self.min_seed_inliers = min_seed_inliers
        self.verify_top_k = verify_top_k
        self.eviction = eviction
        self.match_all = _build_candidate_matcher(
            cfg, max_keyframes, keyframe_budget, loop_match_ratio)
        # Cross-loop verification sees FAR lower inlier fractions than
        # the per-frame solve (no position gate, alias floor): widen the
        # hypothesis pool so a ~10% inlier set still yields all-inlier
        # 3-point samples with near-certainty.
        self.verify_ransac = dataclasses.replace(
            cfg.ransac,
            num_hypotheses=max(256, cfg.ransac.num_hypotheses),
            gn_lm_lambda=1e-3)
        # JITTED verification solver (r5 soak finding): the eager
        # (op-by-op) ransac_pose path leaks ~10 MB of host memory PER
        # CALL on this jax build (measured: 30 eager calls -> +300 MB
        # RSS, flat under jit) — at keyframe cadence that was ~10
        # MB/frame of unbounded growth on long runs.  Shapes are fixed
        # by the store layout, so this compiles once.
        self._verify_pose = jax.jit(
            lambda key, X, obs, valid: ransac_pose(
                key, X, obs, valid, calib, self.verify_ransac))
        self.guided = _build_guided_matcher(cfg, keyframe_budget,
                                            calib, guided_radius)
        # fixed-shape keyframe store (slot ring; kf_frame[i] = -1 empty)
        d = cfg.detector.descriptor_dim_padded
        self.kf_xy = jnp.zeros((max_keyframes, keyframe_budget, 2),
                               jnp.float32)
        self.kf_desc = jnp.zeros((max_keyframes, keyframe_budget, d),
                                 jnp.float32)
        self.kf_X = np.zeros((max_keyframes, keyframe_budget, 3),
                             np.float32)
        self.kf_valid = jnp.zeros((max_keyframes, keyframe_budget), bool)
        self.kf_frames = np.full((max_keyframes,), -1, np.int64)
        self.kf_pos = np.zeros((max_keyframes, 3), np.float32)
        self.n_kf = 0
        self.loops: list = []
        self.candidates: list = []
        # soak/ops counters (not checkpointed — diagnostics only):
        # spatial evictions performed, and new keyframes skipped because
        # they were themselves the redundant member of the closest pair
        self.evicted = 0
        self.store_skipped = 0

    def offer(self, t, xy, desc, obs, X, valid, pos_fn):
        """Process keyframe-cadence frame ``t``: search the store for a
        verified revisit (appending to ``self.loops``/``candidates``),
        then store the new keyframe.  ``pos_fn()`` must return the
        current trajectory position (called AFTER verification — the
        caller may flush device futures inside it)."""
        key = self.key
        budget = self.keyframe_budget
        if self.n_kf > 0:
            idxs, valids, scores = self.match_all(
                xy, desc, valid, self.kf_xy, self.kf_desc, self.kf_valid)
            scores = np.asarray(scores)
            gaps = t - self.kf_frames
            eligible = (self.kf_frames >= 0) & (gaps >= self.min_gap)
            scores = np.where(eligible, scores, -1)
            # Verify the top-k candidates, not just the argmax: the raw
            # match count has an ALIASING FLOOR (random descriptor pairs
            # that pass the ratio test), so the true revisit is not
            # always the top scorer — geometric verification, not the
            # count, is the real arbiter.  First candidate that
            # verifies wins.
            order = np.argsort(-scores)[:self.verify_top_k]
            for best in (int(b) for b in order):
                if scores[best] < self.min_matches:
                    break
                # verify: old keyframe's 3D against the NEW keyframe's
                # stereo observations -> motion old -> new
                m_idx = np.asarray(idxs[best])
                m_valid = np.asarray(valids[best])
                safe = np.clip(m_idx, 0, budget - 1)
                Xp = self.kf_X[best][safe]
                pts_valid = m_valid & (m_idx >= 0)
                est = self._verify_pose(
                    jax.random.fold_in(key, 1_000_000 + t),
                    jnp.asarray(Xp), obs, jnp.asarray(pts_valid))
                diag = {
                    "frame_new": t,
                    "frame_old": int(self.kf_frames[best]),
                    "score": int(scores[best]), "ok": bool(est.ok),
                    "num_inliers": int(est.num_inliers),
                    "refined_inliers": 0}
                self.candidates.append(diag)
                if not (bool(est.ok)
                        and int(est.num_inliers) >= self.min_seed_inliers):
                    continue
                # stage 2: guided re-match under the candidate pose,
                # then re-solve on the recovered support; the FINAL
                # acceptance gate applies to this refined solve.  The
                # re-match is MUTUAL: old->new under est.tr AND
                # new->old under its inverse, keeping only reciprocal
                # pairs — the guided radius gate alone admits ~85%
                # aliases (any new corner near a projected old slot),
                # and aliases are rarely each other's best partner in
                # both directions.
                est2 = est
                for it in range(2):  # re-match under each refined pose
                    g_idx, g_valid, g_dist = self.guided(
                        est2.tr, jnp.asarray(self.kf_X[best]),
                        self.kf_desc[best], self.kf_valid[best],
                        xy, desc, valid)
                    g_idx = np.asarray(g_idx)
                    safe2 = np.clip(g_idx, 0, budget - 1)
                    g_val = np.asarray(g_valid) & (g_idx >= 0)
                    # keep only the best-descriptor quarter of the
                    # guided matches (cap 48): a radius gate under a
                    # seed pose tens of degrees off admits hundreds of
                    # aliases (measured ~5% true), and RANSAC's
                    # 3-sample success odds collapse; true
                    # re-observations concentrate at the small-distance
                    # end
                    g_dist = np.where(g_val, np.asarray(g_dist), np.inf)
                    keep = min(48, max(16, int(g_val.sum()) // 4))
                    thresh = np.partition(g_dist, keep - 1)[keep - 1]
                    g_val = g_val & (g_dist <= thresh)
                    if it > 0:
                        # reciprocal check once the pose has been
                        # refined ONCE: under the seed pose a mutual
                        # filter starves the solve, but under the
                        # round-1 refined pose it cheaply strips
                        # remaining aliases
                        tr_inv = matrix_to_pose_vector(invert_se3(
                            pose_vector_to_matrix(
                                jnp.asarray(est2.tr))))
                        r_idx, r_valid, _ = self.guided(
                            tr_inv.astype(np.float32), X, desc, valid,
                            self.kf_xy[best], self.kf_desc[best],
                            self.kf_valid[best])
                        r_idx = np.asarray(r_idx)
                        mutual = (np.asarray(r_valid)[safe2]
                                  & (r_idx[safe2]
                                     == np.arange(budget)))
                        g_val = g_val & mutual
                    # g maps OLD slot -> NEW slot: solve old 3D vs the
                    # matched new stereo observations
                    est2 = self._verify_pose(
                        jax.random.fold_in(key, 2_000_000 + 2 * t + it),
                        jnp.asarray(self.kf_X[best]),
                        jnp.asarray(np.asarray(obs)[safe2]),
                        jnp.asarray(g_val))
                    diag.setdefault("refine_trace", []).append(
                        (int(g_val.sum()), int(est2.num_inliers)))
                diag["refined_inliers"] = int(est2.num_inliers)
                diag["refined_ok"] = bool(est2.ok)
                # gate on the REFINED inlier count, not est2.ok: the
                # count is evaluated under the refit pose
                # (ransac.py:129-131), so >= min_inliers certifies the
                # pose explains that much support within threshold even
                # when the step-norm `converged` flag stayed false
                # (weak-geometry Cholesky bail or a step oscillating
                # between adjacent minima)
                if int(est2.num_inliers) >= self.min_inliers:
                    self.loops.append(LoopEdge(
                        frame_new=t,
                        frame_old=int(self.kf_frames[best]),
                        tr=np.asarray(est2.tr),
                        num_inliers=int(est2.num_inliers),
                        num_matches=int(scores[best])))
                    break

        # store the new keyframe.  Full store: 'spatial' evicts the
        # most redundant member (coverage-preserving — VERDICT r3 #4);
        # 'fifo' restores the round-3 ring overwrite.
        pos_t = pos_fn()
        if self.n_kf >= self.max_keyframes and self.eviction == "spatial":
            slot = _spatial_evict_slot(self.kf_pos, self.kf_frames, pos_t)
            if slot >= 0:
                self.evicted += 1
            else:
                self.store_skipped += 1
        else:
            slot = self.n_kf % self.max_keyframes
        if slot >= 0:
            self.kf_xy = self.kf_xy.at[slot].set(xy)
            self.kf_desc = self.kf_desc.at[slot].set(desc)
            self.kf_valid = self.kf_valid.at[slot].set(valid)
            self.kf_X[slot] = np.asarray(X)
            self.kf_frames[slot] = t
            self.kf_pos[slot] = pos_t
        self.n_kf += 1

    # ---- checkpoint plumbing (order matches the r4 snapshot layout,
    # so existing loop checkpoints restore across the refactor) ----

    def state_leaves(self):
        return [np.asarray(self.kf_xy), np.asarray(self.kf_desc),
                np.asarray(self.kf_valid), self.kf_X, self.kf_frames,
                np.asarray([self.n_kf]), self.kf_pos]

    def restore(self, leaves, loop_stats):
        (kf_xy, kf_desc, kf_valid, kf_X_r, kf_frames_r,
         n_kf_r, kf_pos_r) = leaves
        self.kf_xy = jnp.asarray(kf_xy)
        self.kf_desc = jnp.asarray(kf_desc)
        self.kf_valid = jnp.asarray(kf_valid)
        self.kf_X = np.asarray(kf_X_r, np.float32)
        self.kf_frames = np.asarray(kf_frames_r, np.int64)
        self.n_kf = int(np.asarray(n_kf_r)[0])
        self.kf_pos = np.asarray(kf_pos_r, np.float32)
        self.loops = [LoopEdge(frame_new=s["new"], frame_old=s["old"],
                               tr=np.asarray(s["tr"], np.float32),
                               num_inliers=s["inliers"],
                               num_matches=s["matches"])
                      for s in loop_stats]

    def loop_stats(self):
        return [{"new": le.frame_new, "old": le.frame_old,
                 "tr": np.asarray(le.tr).tolist(),
                 "inliers": le.num_inliers,
                 "matches": le.num_matches} for le in self.loops]


def close_graph(poses_vo, kf_frames, loops, loop_weight=20.0,
                robust="cauchy", robust_delta=0.05):
    """Assemble + optimize the pose graph over a chained trajectory.

    The graph is built over NODES (keyframe times + endpoints), not raw
    frames: a dense jacfwd + Cholesky over 6T parameters is only
    trivial at a few hundred nodes, and loop edges connect keyframes
    anyway.  Sequential node edges take their z from the chained input
    trajectory (so the combined BA+loop driver hands its BA-refined
    chain here and the graph preserves the refined local motions);
    frames between nodes re-anchor to their segment's optimized node.

    Returns (poses, graph_cost, loop_scale).
    """
    T = len(poses_vo)
    if not loops:
        return poses_vo, (0.0, 0.0), np.zeros((0,), np.float32)
    node_frames = sorted({0, T - 1}
                         | {int(f) for f in kf_frames if f >= 0}
                         | {le.frame_new for le in loops}
                         | {le.frame_old for le in loops})
    node_frames = np.asarray(node_frames, np.int64)
    node_of = {int(f): k for k, f in enumerate(node_frames)}
    K = len(node_frames)
    P_nodes = poses_vo[node_frames]
    ei = np.arange(K - 1, dtype=np.int32)
    ej = ei + 1
    z_seq = np.asarray(invert_se3(jnp.asarray(P_nodes[:-1]))
                       @ jnp.asarray(P_nodes[1:]))
    w = [np.ones((K - 1,), np.float32)]
    for le in loops:
        # est.tr maps old-frame 3D into the new camera:
        # M = T_new^-1 T_old -> edge (i=new, j=old) with z = M
        ei = np.concatenate([ei, [node_of[le.frame_new]]])
        ej = np.concatenate([ej, [node_of[le.frame_old]]])
        z_seq = np.concatenate([
            z_seq, np.asarray(pose_vector_to_matrix(
                jnp.asarray(le.tr)))[None]])
        w.append(np.asarray([loop_weight], np.float32))
    weights = np.concatenate(w)

    # robust kernel on the LOOP edges only (VERDICT r1 #4a): odometry
    # edges are trusted; a false revisit that slipped past geometric
    # verification must not poison the graph — Cauchy IRLS drives an
    # inconsistent edge's influence to ~0 instead of splitting its
    # error across every node.
    is_loop = np.zeros((len(weights),), bool)
    is_loop[K - 1:] = True
    res = optimize_pose_graph(jnp.asarray(P_nodes),
                              jnp.asarray(ei, jnp.int32),
                              jnp.asarray(ej, jnp.int32),
                              jnp.asarray(z_seq), weights=weights,
                              iters=15, robust=robust,
                              robust_mask=jnp.asarray(is_loop),
                              robust_delta=robust_delta)
    poses = np.asarray(reanchor_segments(
        jnp.asarray(poses_vo), jnp.asarray(node_frames, jnp.int32),
        res.poses))
    return poses, (float(res.cost0), float(res.cost)), \
        np.asarray(res.edge_scale)[K - 1:]


def run_with_loop_closure(frames, P1, P2,
                          cfg: PipelineConfig = PipelineConfig(),
                          keyframe_every: int = 5, min_gap: int = 20,
                          min_matches: int = 60, min_inliers: int = 30,
                          max_keyframes: int = 128,
                          keyframe_budget: int = 256,
                          min_seed_inliers: int = 7,
                          guided_radius: float = 16.0,
                          loop_weight: float = 20.0,
                          seed: int = 0,
                          verify_top_k: int = 3,
                          loop_match_ratio: float = 0.8,
                          robust: str = "cauchy",
                          robust_delta: float = 0.05,
                          normalize_desc: bool = True,
                          eviction: str = "spatial",
                          checkpoint=None,
                          fingerprint_scope: str = "",
                          dbg_dir=None) -> LoopClosureResult:
    """Streaming VO + loop detection + pose-graph optimization.

    Args mirror run_stereo_sequence plus the loop-closure knobs
    (including ``checkpoint``/``fingerprint_scope`` — resumable with the
    full keyframe store, bit-exact because every RANSAC key is
    fold_in(key, f(t)) on the absolute frame index — and ``dbg_dir``
    per-frame debug artifacts).  Returns both the optimized and the
    open-chain trajectories so the drift removal is inspectable.

    ``eviction`` governs the full keyframe store (VERDICT r3 #4):
    ``'spatial'`` (default) keeps the store a coverage of the
    trajectory by evicting the newer member of the closest keyframe
    pair (``_spatial_evict_slot``) — loops longer than the store still
    close; ``'fifo'`` restores the round-3 ring overwrite.
    """
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.geometry.se3 import chain_motions
    from libviso_tpu.pipeline.stereo import _jitted_step, empty_state
    from libviso_tpu.utils.debug_viz import DebugDumper

    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    debug = dbg_dir is not None
    dumper = DebugDumper(dbg_dir)
    step = _jitted_step(calib, np.ascontiguousarray(F).tobytes(), cfg,
                        debug)
    key = jax.random.PRNGKey(seed)
    engine = LoopEngine(
        cfg, calib, key, keyframe_every=keyframe_every, min_gap=min_gap,
        min_matches=min_matches, min_inliers=min_inliers,
        max_keyframes=max_keyframes, keyframe_budget=keyframe_budget,
        min_seed_inliers=min_seed_inliers, guided_radius=guided_radius,
        verify_top_k=verify_top_k, loop_match_ratio=loop_match_ratio,
        eviction=eviction)
    summarize = _build_summarize(engine.keyframe_budget,
                                 cfg.detector.descriptor_dim,
                                 normalize_desc)
    state = empty_state(cfg)

    motions_l: list = []
    oks_l: list = []
    t0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_tpu.utils.checkpoint import config_fingerprint

        fingerprint = config_fingerprint(
            cfg, seed,
            scope=(f"loop:{keyframe_every}:{min_gap}:{min_matches}:"
                   f"{min_inliers}:{max_keyframes}:{keyframe_budget}:"
                   f"{loop_match_ratio}:{verify_top_k}:"
                   f"{min_seed_inliers}:{guided_radius}:{robust}:"
                   f"{robust_delta}:{normalize_desc}:{loop_weight}:"
                   f"{eviction}:{fingerprint_scope}"))
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: written with "
                    f"different cfg/knobs ({ck.fingerprint} != "
                    f"{fingerprint})")
            treedef = jax.tree_util.tree_structure(state)
            n_state = len(jax.tree_util.tree_leaves(state))
            state = jax.tree_util.tree_unflatten(
                treedef,
                [jnp.asarray(x) for x in ck.state_leaves[:n_state]])
            engine.restore(ck.state_leaves[n_state:n_state + 7],
                           ck.stats)
            motions_l = [m for m in ck.motions]
            oks_l = [bool(o) for o in ck.oks]
            t0 = ck.next_frame

    pending: list = []

    def _flush():
        for out in pending:
            motions_l.append(np.asarray(out.tr))
            oks_l.append(bool(out.ok))
        pending.clear()

    # running VO pose for keyframe positions (spatial eviction).  The
    # chain advances lazily at keyframe times (which already host-sync
    # for the candidate search), never per frame.
    P_run = np.eye(4)
    chained_upto = [0]

    def _advance_chain():
        """Chain motions_l[chained_upto:] into P_run; return position."""
        nonlocal P_run
        lo = chained_upto[0]
        if len(motions_l) > lo:
            # host-side numpy 4x4 chaining: the stack length varies with
            # flush cadence/resume, so a jax round-trip here would
            # recompile per new shape
            from libviso_tpu.synthetic import _pose_matrix_np

            Ts = _pose_matrix_np(np.stack(motions_l[lo:]))
            for k, T in enumerate(Ts):
                if oks_l[lo + k]:
                    R, tt = T[:3, :3], T[:3, 3]
                    Tinv = np.eye(4)
                    Tinv[:3, :3] = R.T
                    Tinv[:3, 3] = -R.T @ tt
                    P_run = P_run @ Tinv
            chained_upto[0] = len(motions_l)
        return P_run[:3, 3].astype(np.float32)

    def _snapshot(next_frame):
        from libviso_tpu.utils.checkpoint import Checkpoint

        leaves = ([np.asarray(x)
                   for x in jax.tree_util.tree_leaves(state)]
                  + engine.state_leaves())
        checkpoint.save(Checkpoint(
            next_frame=next_frame,
            motions=(np.stack(motions_l) if motions_l
                     else np.zeros((0, 6))),
            oks=np.asarray(oks_l, bool),
            state_leaves=leaves,
            stats=engine.loop_stats(),
            fingerprint=fingerprint,
        ))

    start = 0
    if t0 and hasattr(frames, "skipped"):
        frames = frames.skipped(t0)
        start = t0
    prev_host = None
    for t, (im1, im2) in enumerate(frames, start=start):
        if t < t0:  # restored from checkpoint
            continue
        im1 = jnp.asarray(im1)
        im2 = jnp.asarray(im2)
        prev_state = state
        if debug:
            state, out, dbg = step(state, im1, im2,
                                   jax.random.fold_in(key, t))
            from libviso_tpu.ops.matching import MatchResult

            mlr = MatchResult(idx=dbg.match_lr,
                              dist=jnp.zeros_like(dbg.kp1.response),
                              valid=dbg.match_lr >= 0)
            dumper.frame(
                t, np.asarray(im1), np.asarray(im2), dbg.kp1,
                dbg.kp2, mlr,
                prev=(prev_host[0], prev_host[1], prev_state.kp1,
                      prev_state.kp2) if prev_host else None,
                circ=dbg.circle if t > 0 else None,
                predict=dbg.predict if t > 0 else None,
                obs=dbg.obs if t > 0 else None,
                inliers=dbg.inliers if t > 0 else None)
            prev_host = (np.asarray(im1), np.asarray(im2))
        else:
            state, out = step(state, im1, im2, jax.random.fold_in(key, t))
        pending.append(out)
        # snapshots happen at the END of a frame's work (after any
        # keyframe-store update for frame t — a snapshot taken before it
        # would resume WITHOUT frame t's keyframe and diverge from the
        # uninterrupted run)
        if t % keyframe_every != 0:
            if checkpoint is not None and (t + 1) % checkpoint.every == 0:
                _flush()
                _snapshot(t + 1)
            continue

        xy, desc, obs, X, valid = summarize(state)

        def _pos():
            # flush device futures, then chain host-side: the engine
            # calls this AFTER verification (spatial eviction needs the
            # position of frame t)
            _flush()
            return _advance_chain()

        engine.offer(t, xy, desc, obs, X, valid, _pos)
        if checkpoint is not None and (t + 1) % checkpoint.every == 0:
            _snapshot(t + 1)

    # ---- assemble trajectory + pose graph ----
    _flush()
    if checkpoint is not None and motions_l:
        _snapshot(len(motions_l))  # final snapshot: a rerun is a no-op
    if not motions_l:
        empty6 = np.zeros((0, 6), np.float32)
        empty44 = np.zeros((0, 4, 4), np.float32)
        return LoopClosureResult(poses=empty44, poses_vo=empty44,
                                 motions=empty6,
                                 frame_ok=np.zeros((0,), bool), loops=[],
                                 graph_cost=(0.0, 0.0),
                                 loop_edge_scale=np.zeros((0,),
                                                          np.float32),
                                 candidates=[], processed=0)
    motions = np.stack(motions_l)
    oks = np.asarray(oks_l, bool)
    oks[0] = False
    Ts = pose_vector_to_matrix(jnp.asarray(motions))
    poses_vo = np.asarray(chain_motions(Ts, jnp.asarray(oks)))

    poses, graph_cost, loop_scale = close_graph(
        poses_vo, engine.kf_frames, engine.loops,
        loop_weight=loop_weight, robust=robust,
        robust_delta=robust_delta)

    return LoopClosureResult(poses=poses, poses_vo=poses_vo,
                             motions=motions, frame_ok=oks,
                             loops=engine.loops,
                             graph_cost=graph_cost,
                             loop_edge_scale=loop_scale,
                             candidates=engine.candidates,
                             processed=max(0, len(motions) - t0),
                             keyframes_offered=engine.n_kf,
                             evictions=engine.evicted,
                             store_skipped=engine.store_skipped)
