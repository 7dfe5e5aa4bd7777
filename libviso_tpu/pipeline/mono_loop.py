"""Monocular Sim(3) loop-closure back-end (scale-drift-aware).

The mono pipeline's propagated scale DRIFTS — measured r5: ~19% of path
length over 300 frames (docs/limitations.md "Next-round candidates" #0)
— and the SE(3) back-ends cannot repair it: a 6-dof loop edge has no
coordinate for "this lap came back 12% smaller", so feeding a mono loop
into the rigid pose graph either mis-attributes the scale error as
translation or gets the edge killed by the robust kernel.  This driver
is the classic remedy (Strasdat et al., "Scale Drift-Aware Large Scale
Monocular SLAM", RSS 2010) built from the engine's own parts:

  1. mono VO with relative-scale propagation (pipeline/mono.py) — the
     front-end runs ONCE; keyframe snapshots reuse its jitted step
     state, no second detection/matching pass;
  2. keyframe store + appearance candidate matching — the stereo loop
     engine's batched matcher, reused verbatim
     (pipeline/loop.py::_build_candidate_matcher);
  3. loop verification by 3D-3D **Sim(3)** RANSAC (Umeyama solver,
     geometry/procrustes.py::ransac_similarity) on the matched landmark
     clouds.  At a true revisit the relative BASELINE is drift-sized
     (near zero), so two-view triangulation of the loop pair
     degenerates — but each visit already carries its own propagated
     landmark depths, and aligning the two clouds observes rotation,
     translation AND the relative scale ratio directly;
  4. a Sim(3) pose graph over keyframe nodes
     (solvers/pose_graph_sim3.py) with s=1 odometry edges and measured
     Sim(3) loop edges, Cauchy-robust on the loop edges; segments
     re-anchor through their node's similarity correction.

Beyond-reference: the reference's mono path abandons reconstruction
entirely (src/viso.cpp:1393-1396); its loop machinery does not exist.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.config import MonoConfig, PipelineConfig
from libviso_tpu.geometry.essential import normalize_points
from libviso_tpu.geometry.mvg import e2h
from libviso_tpu.geometry.procrustes import ransac_similarity
from libviso_tpu.geometry.se3 import invert_se3
from libviso_tpu.geometry.sim3 import sim3_scale
from libviso_tpu.pipeline.loop import _build_candidate_matcher
from libviso_tpu.pipeline.mono import (
    _jitted_mono_step,
    chain_mono_outputs,
    empty_mono_state,
)
from libviso_tpu.solvers.pose_graph_sim3 import (
    optimize_sim3_graph,
    reanchor_segments_sim3,
)


class MonoLoopEdge(NamedTuple):
    frame_old: int
    frame_new: int
    num_inliers: int
    num_candidates: int   # appearance matches that fed the verification
    s_rel: float          # relative scale u_new / u_old of the closure
    z: np.ndarray         # (4, 4) Sim(3): new-keyframe coords -> old


@dataclasses.dataclass
class MonoLoopResult:
    poses: np.ndarray        # (T, 4, 4) Sim(3)-graph-corrected SE(3)
    poses_vo: np.ndarray     # (T, 4, 4) open-chain mono VO
    frame_ok: np.ndarray
    speeds: np.ndarray
    stats: list
    kf_frames: np.ndarray    # frames that became keyframe nodes
    loops: List[MonoLoopEdge]
    graph_cost: tuple        # (cost0, cost) under the final IRLS scaling
    node_scales: np.ndarray  # (K,) optimized per-node scale corrections
    edge_scale: np.ndarray   # (n_loops,) robust IRLS weight per loop edge


def _build_kf_summarize(budget: int, desc_dim: int):
    """jit: MonoState -> compact keyframe (xy, gain-normalized desc,
    step-unit landmark depth, validity).

    Descriptor normalization matches the stereo keyframe store
    (pipeline/loop.py::summarize_keyframe): zero-mean unit-L2 over the
    real dims x1024 — revisit detection survives exposure change.
    """

    @jax.jit
    def summarize(state):
        usable = state.kp.valid & state.depth_valid
        score = jnp.where(usable, state.kp.response, -jnp.inf)
        _, top = jax.lax.top_k(score, budget)
        valid = jnp.take_along_axis(usable, top, axis=0)
        desc = state.desc[top]
        d = desc[:, :desc_dim]
        d = d - d.mean(axis=-1, keepdims=True)
        d = d / jnp.maximum(
            jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
        desc = jnp.zeros_like(desc).at[:, :desc_dim].set(d * 1024.0)
        return state.kp.xy[top], desc, state.depth[top], valid

    return summarize


def _build_sim3_verifier(K, budget: int, num_hypotheses: int,
                         inlier_thresh: float):
    """jit: matched keyframe landmark clouds -> Sim(3) + inlier count.

    Landmarks are back-projected from each keyframe's own normalized
    rays and propagated depths (already in trajectory units); the
    returned transform maps NEW-keyframe points onto the OLD keyframe
    (``T @ X_new ~= X_old``), whose scale component is the measured
    drift ratio u_new / u_old.
    """
    Kj = jnp.asarray(np.asarray(K, np.float64), jnp.float32)

    @jax.jit
    def verify(key, xy_new, depth_new, v_new, xy_old, depth_old, v_old,
               idx, mvalid):
        idx_safe = jnp.clip(idx, 0, budget - 1)
        X_new = depth_new[:, None] * e2h(normalize_points(xy_new, Kj))
        X_old = (depth_old[:, None]
                 * e2h(normalize_points(xy_old, Kj)))[idx_safe]
        pv = (mvalid & v_new & v_old[idx_safe]
              & (depth_new > 1e-6) & (depth_old[idx_safe] > 1e-6))
        Z, inl, n_inl = ransac_similarity(
            key, X_old, X_new, valid=pv,
            num_hypotheses=num_hypotheses, inlier_thresh=inlier_thresh)
        return Z, n_inl, jnp.sum(pv.astype(jnp.int32))

    return verify


def run_mono_sim3_loop(frames: Iterable, K,
                       cfg: PipelineConfig = None,
                       mono: MonoConfig = None,
                       seed: int = 0,
                       keyframe_every: int = 4,
                       min_gap: int = 10,
                       min_matches: int = 20,
                       min_inliers: int = 12,
                       budget: int = 256,
                       candidate_ratio: float = 0.8,
                       loop_inlier_thresh: float = 0.5,
                       loop_ransac_hyps: int = 128,
                       loop_weight: float = 20.0,
                       max_scale_ratio: float = 4.0,
                       graph_iters: int = 10,
                       robust_schedule=(0.5, 0.15, 0.05),
                       D=None) -> MonoLoopResult:
    """Mono VO + Sim(3) loop closure over one front-end pass.

    Args beyond ``run_mono_sequence``'s:
      keyframe_every: keyframe cadence in frames (nodes of the graph).
      min_gap: minimum FRAME separation for a loop candidate (excludes
        trivially-adjacent keyframes).
      min_matches: appearance-match support to attempt verification.
      min_inliers: Sim(3)-RANSAC consensus to accept a loop edge.
      budget: landmark slots stored per keyframe (top-response).
      loop_inlier_thresh: 3D consensus radius in trajectory units.
      loop_weight / max_scale_ratio: edge weight in the graph; sanity
        bound on the measured relative scale (a ratio outside
        [1/r, r] is a verification alias, not drift).
      robust_schedule: graduated non-convexity — the Cauchy delta is
        annealed over successive solves (``graph_iters`` GN steps
        each).  At the stereo drivers' fixed delta=0.05 a TRUE mono
        loop edge (residual = the accumulated drift, ~1-2.5 units)
        is attenuated to ~1e-4 weight and its pull is glacial;
        starting at 0.5 lets true edges move the graph while a false
        edge (residual ~10x larger) stays suppressed through every
        round.  Calibrated on the injected-drift circuit battery
        (tests/test_sim3.py): (0.5, 0.15, 0.05) closes the loop to
        ATE 0.18 (VO 1.53) with and WITHOUT a planted false edge
        (final false-edge weight 0.000); starting at 1.0 or 2.0 lets
        the false edge drag the basin (ATE 5.7 / 7.5).

    Returns MonoLoopResult; ``poses`` falls back to the open chain when
    no loop verifies (the reference situation, except the reference has
    no chain at all — src/viso.cpp:1393-1396).
    """
    if cfg is None:
        cfg = PipelineConfig.mono()
    mono = mono or MonoConfig()
    step = _jitted_mono_step(
        np.ascontiguousarray(K, np.float64).tobytes(), cfg, mono,
        None if D is None else tuple(float(d) for d in D))
    key = jax.random.PRNGKey(seed)

    # --- front-end pass: accumulate outputs as device futures, snapshot
    # the jitted step's state at keyframe cadence (holding the pytree
    # costs no sync; MonoState after step t describes frame t) ---
    state = empty_mono_state(cfg)
    outs, kf_snaps = [], []
    for t, im in enumerate(frames):
        state, out = step(state, jnp.asarray(im),
                          jax.random.fold_in(key, t))
        outs.append(out)
        if t >= keyframe_every and t % keyframe_every == 0:
            kf_snaps.append((t, state))

    poses_vo, oks, speeds, stats = chain_mono_outputs(outs, mono)
    T = len(poses_vo)

    # --- keyframe store: summarize snapshots whose frame was accepted
    # (a held/failed frame's depths are not in chartable units) ---
    summarize = _build_kf_summarize(budget, cfg.detector.descriptor_dim)
    kf_frames, kf_xy, kf_desc, kf_depth, kf_valid = [], [], [], [], []
    for t, st in kf_snaps:
        if not (oks[t] and speeds[t] > 0):
            continue
        xy, desc, depth, valid = summarize(st)
        kf_frames.append(t)
        kf_xy.append(np.asarray(xy))
        kf_desc.append(np.asarray(desc))
        # step-unit depths -> trajectory units via the applied speed
        kf_depth.append(np.asarray(depth) * float(speeds[t]))
        kf_valid.append(np.asarray(valid))

    def _no_loops():
        return MonoLoopResult(
            poses=poses_vo.copy(), poses_vo=poses_vo, frame_ok=oks,
            speeds=speeds, stats=stats,
            kf_frames=np.asarray(kf_frames, np.int64),
            loops=[], graph_cost=(0.0, 0.0),
            node_scales=np.ones((len(kf_frames),), np.float32),
            edge_scale=np.zeros((0,), np.float32))

    Kf = len(kf_frames)
    if Kf < 2:
        return _no_loops()

    # --- appearance candidates: the stereo loop engine's batched
    # matcher over the whole store (one launch per query keyframe) ---
    match_all = _build_candidate_matcher(cfg, Kf, budget,
                                         candidate_ratio)
    st_xy = jnp.asarray(np.stack(kf_xy))
    st_desc = jnp.asarray(np.stack(kf_desc))
    st_valid = jnp.asarray(np.stack(kf_valid))

    verify = _build_sim3_verifier(K, budget, loop_ransac_hyps,
                                  loop_inlier_thresh)
    vkey = jax.random.fold_in(key, 1_000_003)
    loops: List[MonoLoopEdge] = []
    for q in range(1, Kf):
        allowed = np.array([kf_frames[q] - kf_frames[k] >= min_gap
                            for k in range(Kf)])
        allowed[q:] = False
        if not allowed.any():
            continue
        idx, mval, scores = match_all(
            st_xy[q], st_desc[q], st_valid[q], st_xy, st_desc, st_valid)
        scores = np.where(allowed, np.asarray(scores), -1)
        best = int(np.argmax(scores))
        if scores[best] < min_matches:
            continue
        Z, n_inl, _ = verify(
            jax.random.fold_in(vkey, q),
            st_xy[q], jnp.asarray(kf_depth[q]), st_valid[q],
            st_xy[best], jnp.asarray(kf_depth[best]), st_valid[best],
            idx[best], mval[best])
        n_inl = int(n_inl)
        if n_inl < min_inliers:
            continue
        s_rel = float(sim3_scale(Z))
        if not (np.isfinite(s_rel)
                and 1.0 / max_scale_ratio < s_rel < max_scale_ratio):
            continue
        loops.append(MonoLoopEdge(
            frame_old=kf_frames[best], frame_new=kf_frames[q],
            num_inliers=n_inl, num_candidates=int(scores[best]),
            s_rel=s_rel, z=np.asarray(Z)))

    if not loops:
        return _no_loops()

    # --- Sim(3) graph over nodes = keyframes + endpoints ---
    node_frames = np.asarray(
        sorted({0, T - 1} | set(kf_frames)), np.int64)
    node_of = {int(f): k for k, f in enumerate(node_frames)}
    Kn = len(node_frames)
    P_nodes = poses_vo[node_frames]
    ei = np.arange(Kn - 1, dtype=np.int32)
    ej = ei + 1
    z_seq = np.asarray(invert_se3(jnp.asarray(P_nodes[:-1]))
                       @ jnp.asarray(P_nodes[1:]))   # s = 1 odometry
    w = [np.ones((Kn - 1,), np.float32)]
    for le in loops:
        # le.z maps new-kf coords -> old-kf coords = S_old^-1 S_new,
        # i.e. the graph edge (i=old, j=new)
        ei = np.concatenate([ei, [node_of[le.frame_old]]])
        ej = np.concatenate([ej, [node_of[le.frame_new]]])
        z_seq = np.concatenate([z_seq, le.z[None]])
        w.append(np.asarray([loop_weight], np.float32))
    weights = np.concatenate(w)
    is_loop = np.zeros((len(weights),), bool)
    is_loop[Kn - 1:] = True

    P = jnp.asarray(P_nodes)
    for delta in robust_schedule:
        res = optimize_sim3_graph(
            P, jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            jnp.asarray(z_seq), weights=weights, iters=graph_iters,
            robust="cauchy", robust_mask=jnp.asarray(is_loop),
            robust_delta=delta)
        P = res.poses
    poses = np.asarray(reanchor_segments_sim3(
        jnp.asarray(poses_vo), jnp.asarray(node_frames, jnp.int32),
        res.poses))
    return MonoLoopResult(
        poses=poses, poses_vo=poses_vo, frame_ok=oks, speeds=speeds,
        stats=stats, kf_frames=np.asarray(kf_frames, np.int64),
        loops=loops,
        graph_cost=(float(res.cost0), float(res.cost)),
        node_scales=np.asarray(sim3_scale(res.poses)),
        edge_scale=np.asarray(res.edge_scale)[Kn - 1:])
