"""Stereo visual odometry pipeline (SURVEY.md C2).

The reference's frame loop (``sequence_odometry``, src/viso.cpp:1167-1330):

  detect -> describe -> LR match (epipolar-gated) -> triangulate ->
  temporal matches -> circular consistency -> RANSAC+GN pose ->
  pose = pose * Tr^-1

re-designed as one compiled program: the entire per-frame computation from
detection through the RANSAC refit is ONE jit-compiled, fixed-shape graph
(``build_frame_step``).  Keypoints are padded slot tensors, matches are
index tables with -1 sentinels, "skip this frame" (src/viso.cpp:1283-1288,
1322-1324) is a per-frame validity flag, and the previous-frame state the
C++ keeps in mutable locals (src/viso.cpp:1208-1222) is an explicit pytree
threaded through the loop.

The host loop only feeds images and collects 6-dof motions; global poses
are composed afterwards with an associative scan (geometry/se3.py) so the
same step also batches/shards over sequence chunks (parallel/odometry.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.config import Calib, PipelineConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.geometry.se3 import chain_motions
from libviso_tpu.geometry.triangulate import triangulate_rectified
from libviso_tpu.ops.circle import circle_filter
from libviso_tpu.ops.features import Keypoints, detect_and_describe
from libviso_tpu.ops.matching import match_frame_triple
from libviso_tpu.solvers.ransac import ransac_pose


class FrameState(NamedTuple):
    """Previous-frame memory carried across steps (viso.cpp:1192-1201)."""

    kp1: Keypoints   # left keypoints
    kp2: Keypoints   # right keypoints
    d1: jax.Array    # (N, D) left descriptors
    d2: jax.Array    # (N, D) right descriptors
    match_lr: jax.Array  # (N,) int32 left-slot -> right-slot
    X: jax.Array     # (N, 3) triangulated 3D per left slot
    X_valid: jax.Array  # (N,) bool
    # consecutive solves failed while these features were HELD as the
    # match target (cfg.keep_features_on_failure; always 0 otherwise)
    fail_age: jax.Array  # () int32


class FrameOutput(NamedTuple):
    tr: jax.Array           # (6,) motion previous -> current
    ok: jax.Array           # () bool — pose accepted
    num_circle: jax.Array   # () int32 circular matches
    num_inliers: jax.Array  # () int32 RANSAC support size
    num_lr: jax.Array       # () int32 stereo matches
    num_kp1: jax.Array      # () int32 detected left corners
    rms: jax.Array          # () reprojection RMS over the support
    #                         (reference logs it, viso.cpp:1577-1578)
    # mean Harris response over detected corners: an image-sharpness
    # health signal.  Measured (docs/realism.md "Breaking points"):
    # heavy defocus biases corner localization CONSISTENTLY, so the
    # ok/rms consistency checks stay green while the trajectory walks
    # meters off — response mass collapses with blur and is the cheap
    # observable that does trip.  ~free: the responses are already in
    # registers at detection time.
    sharpness: jax.Array    # () float


class FrameDebug(NamedTuple):
    """Extra per-frame tensors for the debug artifact writer (C17)."""

    circle: object          # CircleResult
    inliers: jax.Array      # (N,) bool RANSAC support mask
    obs: jax.Array          # (N, 4) current observations per left slot
    predict: jax.Array      # (N, 4) reprojections under the estimated tr
    # the CURRENT frame's raw detections/LR matches — drivers must draw
    # these, not the post-step state: under keep_features_on_failure a
    # failed frame's state holds the PREVIOUS frame's features, which
    # would be mislabeled as this frame's detections in the artifacts
    kp1: Keypoints
    kp2: Keypoints
    match_lr: jax.Array     # (N,) int32


class Feats(NamedTuple):
    """Front-end output for one stereo frame — the detect->match seam.
    (The pipeline-parallel stage boundary is SolveInput, further down the
    step; Feats stays within stage 0.)"""

    kp1: Keypoints   # left keypoints
    d1: jax.Array    # (N, D) left descriptors
    kp2: Keypoints   # right keypoints
    d2: jax.Array    # (N, D) right descriptors


def empty_state(cfg: PipelineConfig, dtype=jnp.float32) -> FrameState:
    """All-invalid state for the first frame (``first`` flag analog)."""
    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    kp = Keypoints(
        xy=jnp.zeros((n, 2), dtype),
        response=jnp.zeros((n,), dtype),
        valid=jnp.zeros((n,), bool),
    )
    return FrameState(
        kp1=kp, kp2=kp,
        d1=jnp.zeros((n, d), dtype), d2=jnp.zeros((n, d), dtype),
        match_lr=jnp.full((n,), -1, jnp.int32),
        X=jnp.zeros((n, 3), dtype),
        X_valid=jnp.zeros((n,), bool),
        fail_age=jnp.zeros((), jnp.int32),
    )


def build_frontend(cfg: PipelineConfig):
    """Build the per-frame FRONT-END: detection + description only.

    frontend(im1, im2) -> Feats.  Depends only on the current frame's
    images — this is the stage-0 half of the pipeline-parallel split
    (SURVEY.md P4); `build_frame_step` composes it with `build_backend`
    for the fused single-chip step.
    """

    def frontend(im1, im2) -> Feats:
        # Both views detected as one vmapped batch: one fused kernel
        # launch, 2x arithmetic intensity (vs the reference's two serial
        # detector.detect calls, viso.cpp:1226-1227).
        det = cfg.detector
        gate = None
        if det.sharpen_sigma > 0 and det.sharpen_auto:
            # ONE defocus decision per stereo pair (mean of the views'
            # metrics): a pair straddling the trigger must never have
            # only one view sharpened — descriptors across differently-
            # processed views stop matching (ops/features.py).
            from libviso_tpu.ops.features import blur_metric

            stacked = jnp.stack([im1, im2]).astype(jnp.float32)
            gate = (jnp.mean(jax.vmap(blur_metric)(stacked))
                    < det.sharpen_trigger)
        kps, ds = jax.vmap(
            lambda im: detect_and_describe(im, det, sharpen_gate=gate)
        )(jnp.stack([im1, im2]))
        pick = lambda tree, i: jax.tree_util.tree_map(lambda x: x[i], tree)
        return Feats(kp1=pick(kps, 0), d1=ds[0],
                     kp2=pick(kps, 1), d2=ds[1])

    return frontend


class SolveInput(NamedTuple):
    """Everything the pose solve needs about one frame — the prepare/solve
    seam, and the stage boundary of the rebalanced pipeline-parallel
    layout (~21 KB/frame vs ~1.4 MB of raw Feats; debug-only tensors
    like the CircleResult stay on the prepare side)."""

    Xp: jax.Array          # (N, 3) previous-frame 3D per circle match
    obs: jax.Array         # (N, 4) current observations (u_l,v_l,u_r,v_r)
    pts_valid: jax.Array   # (N,) usable correspondences
    circ_count: jax.Array  # () int32
    num_lr: jax.Array      # () int32 (FrameOutput stats)
    num_kp1: jax.Array     # () int32
    sharpness: jax.Array   # () float (FrameOutput health signal)


def zero_solve_input(cfg: PipelineConfig, dtype=jnp.float32) -> SolveInput:
    """All-invalid SolveInput (pipeline bubble filler; solving it yields
    ok=False exactly like an empty first frame)."""
    n = cfg.detector.num_slots
    z = jnp.zeros((), jnp.int32)
    return SolveInput(
        Xp=jnp.zeros((n, 3), dtype), obs=jnp.zeros((n, 4), dtype),
        pts_valid=jnp.zeros((n,), bool), circ_count=z, num_lr=z,
        num_kp1=z, sharpness=jnp.zeros((), dtype))


def match_layout(cfg: PipelineConfig, image_width):
    """(nbinx, nbiny, k, num_slots) for the strip-banded matcher, or
    None when banding does not apply (no width known, multi-scale
    detection whose slot blocks are per-level, or disabled by
    ``stereo_match.banded``)."""
    det = cfg.detector
    if (image_width is None or det.pyramid_levels > 1
            or not cfg.stereo_match.banded):
        return None
    return (det.nbinx, det.nbiny, det.corners_per_bin, det.num_slots)


def build_prepare(calib: Calib, F, cfg: PipelineConfig, image_width=None):
    """Matching through correspondence gathering — all per-frame work
    EXCEPT the RANSAC solve.  prepare(feats, state) -> (new_state,
    SolveInput, CircleResult); the CircleResult is for the debug artifact
    writer only and stays out of the pipeline-parallel seam.

    ``image_width`` (static) enables the strip-banded matcher
    (ops/matching.py::match_problem_batch) — callers that know the
    frame shape at trace time pass it; None keeps the dense path."""
    F = jnp.asarray(F)
    layout = match_layout(cfg, image_width)

    def prepare(feats: Feats, state: FrameState):
        kp1, d1, kp2, d2 = feats.kp1, feats.d1, feats.kp2, feats.d2

        # All three match problems (LR epipolar-gated + both temporal,
        # viso.cpp:1240,1264,1275) as ONE vmapped (3, N, N) batch.
        mlr, m11, m22 = match_frame_triple(
            kp1, d1, kp2, d2, state.kp1, state.d1, state.kp2, state.d2,
            cfg.stereo_match, cfg.temporal_match, F,
            layout=layout, image_width=image_width)

        # Per-left-slot observations (u_l, v_l, u_r, v_r) and 3D points
        # (collect_matches + triangulate_rectified, viso.cpp:1246-1247).
        r_safe = jnp.clip(mlr.idx, 0, cfg.detector.num_slots - 1)
        obs = jnp.concatenate([kp1.xy, kp2.xy[r_safe]], axis=-1)
        X = triangulate_rectified(obs, calib.f, calib.base, calib.cu,
                                  calib.cv)

        # Circular consistency (viso.cpp:1282).
        circ = circle_filter(mlr.idx, state.match_lr, m11.idx, m22.idx)

        # Gather previous-frame 3D + current observations
        # (viso.cpp:1292-1305).
        lp_safe = jnp.clip(circ.left_prev, 0, cfg.detector.num_slots - 1)
        Xp = state.X[lp_safe]
        pts_valid = circ.valid & state.X_valid[lp_safe] & mlr.valid

        new_state = FrameState(
            kp1=kp1, kp2=kp2, d1=d1, d2=d2,
            match_lr=mlr.idx, X=X, X_valid=mlr.valid,
            fail_age=jnp.zeros((), jnp.int32),
        )
        n_kp1 = jnp.sum(kp1.valid.astype(jnp.int32))
        si = SolveInput(
            Xp=Xp, obs=obs, pts_valid=pts_valid, circ_count=circ.count,
            num_lr=jnp.sum(mlr.valid.astype(jnp.int32)),
            num_kp1=n_kp1,
            sharpness=(jnp.sum(jnp.where(kp1.valid, kp1.response, 0.0))
                       / jnp.maximum(n_kp1, 1)))
        return new_state, si, circ

    return prepare


def build_solve(calib: Calib, cfg: PipelineConfig, debug: bool = False):
    """The RANSAC+GN pose solve on a prepared frame.

    solve(si, key) -> FrameOutput — the stage-1 half of the
    pipeline-parallel split.  With ``debug`` also returns the RANSAC
    support mask and reprojections (the solve-side halves of FrameDebug;
    the prepare side supplies the CircleResult)."""

    def solve(si: SolveInput, key):
        rk, = jax.random.split(key, 1)
        est = ransac_pose(rk, si.Xp, si.obs, si.pts_valid, calib,
                          cfg.ransac)

        ok = est.ok & (si.circ_count >= cfg.min_circle_matches)
        tr = jnp.where(ok, est.tr, jnp.zeros_like(est.tr))

        out = FrameOutput(
            tr=tr, ok=ok,
            num_circle=si.circ_count,
            num_inliers=est.num_inliers,
            num_lr=si.num_lr,
            num_kp1=si.num_kp1,
            rms=est.rms,
            sharpness=si.sharpness,
        )
        if debug:
            from libviso_tpu.solvers.gauss_newton import stereo_predict

            predict, _ = stereo_predict(est.tr, si.Xp, calib)
            return out, est.inliers, predict
        return out

    return solve


def hold_state_on_failure(state, new_state, ok, has_history, max_age):
    """Dropout recovery (cfg.keep_features_on_failure): when the solve
    FAILED, hold the previous (good) state as the next frame's match
    target instead of the bad frame's — unless the held state is empty
    (``has_history`` False at startup) or has already been held
    ``max_age`` times (a genuinely changed scene must re-sync, not
    pin).  Scalar select over the state pytree; no host sync.  Shared
    by the stereo and mono steps (both states carry ``fail_age``)."""
    keep = (~ok) & has_history & (state.fail_age < max_age)
    merged = jax.tree_util.tree_map(
        lambda old, new: jnp.where(keep, old, new), state, new_state)
    return merged._replace(fail_age=jnp.where(keep, state.fail_age + 1, 0))


def build_backend(calib: Calib, F, cfg: PipelineConfig, debug: bool = False,
                  image_width=None):
    """Build the per-frame BACK-END: matching through pose estimation
    (prepare ∘ solve).

    backend_fn(feats, state, key) -> (new_state, FrameOutput[, FrameDebug]).
    Consumes the front-end's features for the CURRENT frame plus the
    previous-frame state.
    """
    prepare = build_prepare(calib, F, cfg,
                            image_width=image_width)
    solve = build_solve(calib, cfg, debug=debug)

    def backend_fn(feats: Feats, state: FrameState, key):
        new_state, si, circ = prepare(feats, state)
        cur_match_lr = new_state.match_lr  # pre-merge: this frame's own
        res = solve(si, key)
        out = res[0] if debug else res
        if cfg.keep_features_on_failure:
            new_state = hold_state_on_failure(
                state, new_state, out.ok, jnp.any(state.kp1.valid),
                cfg.max_keep_age)
        if debug:
            _, inliers, predict = res
            dbg = FrameDebug(circle=circ, inliers=inliers, obs=si.obs,
                             predict=predict, kp1=feats.kp1,
                             kp2=feats.kp2, match_lr=cur_match_lr)
            return new_state, out, dbg
        return new_state, out

    return backend_fn


def build_frame_step(calib: Calib, F, cfg: PipelineConfig,
                     debug: bool = False):
    """Build the jit-compiled per-frame VO step (frontend ∘ backend).

    Args:
      calib: rectified stereo calibration.
      F: (3, 3) fundamental matrix for the LR epipolar gate (computed once
        per sequence on the host in f64 — see F_from_P_host).
      cfg: pipeline configuration (static).
      debug: also return a FrameDebug with the tensors the artifact
        writer needs (reference param.save_debug analog, src/viso.h:60).

    Returns:
      step(state, im1, im2, key) -> (new_state, FrameOutput[, FrameDebug]),
      jittable.
    """
    frontend = build_frontend(cfg)

    def step(state: FrameState, im1, im2, key):
        # backend built at TRACE time so the static frame width reaches
        # the strip-banded matcher (cheap Python closure construction;
        # the jit cache keys on `step`, which is stable)
        backend_fn = build_backend(calib, F, cfg,
                                   debug=debug,
                                   image_width=im1.shape[-1])
        return backend_fn(frontend(im1, im2), state, key)

    return step


def build_frame_chunk(calib: Calib, F, cfg: PipelineConfig, chunk: int):
    """K consecutive frame steps as ONE dispatch (a `lax.scan` of the
    per-frame step over a (K, H, W) frame stack).

    Per-frame semantics are untouched — the scan body IS `build_frame_step`
    with the state threaded through, so outputs are bitwise identical to K
    separate `step` calls (tested: tests/test_pipeline.py chunked-streaming
    equivalence).  What changes is the dispatch granularity: one launch
    covers K frames, so fixed per-dispatch overhead (host dispatch and
    kernel-launch bookkeeping) divides by K.  Whether that pays on a
    directly attached GPU is not measured yet (ROADMAP 1.6).

    The cost is latency: results arrive K frames at a time, and the host
    must have K frames on hand.  The offline/recorded-sequence drivers this
    framework targets (KITTI playback, the reference's own batch mode,
    src/kitti.cpp:79-118) read frames ahead anyway (native prefetch
    loader), so chunk>1 is pure throughput for them; a live sensor loop
    that needs every pose within a frame time keeps chunk=1.

    Returns:
      chunk_step(state, lefts, rights, keys) ->
          (new_state, FrameOutput stacked over the leading K axis)
      where lefts/rights are (K, H, W) and keys is a (K,)-stacked PRNG key
      array (one `fold_in(key, t)` per frame, preserving the bit-exact
      resume contract).
    """
    step = build_frame_step(calib, F, cfg)

    def chunk_step(state: FrameState, lefts, rights, keys):
        def body(st, xs):
            im1, im2, k = xs
            st, out = step(st, im1, im2, k)
            return st, out

        return jax.lax.scan(body, state, (lefts, rights, keys))

    return chunk_step


import functools


@functools.lru_cache(maxsize=16)
def _jitted_step(calib: Calib, f_bytes: bytes, cfg: PipelineConfig,
                 debug: bool):
    """One jitted frame step per configuration: repeated driver calls
    (multi-sequence runs, tests) reuse the compiled program instead of
    paying the ~20 s front-end compile again."""
    F = np.frombuffer(f_bytes, np.float64).reshape(3, 3)
    return jax.jit(build_frame_step(calib, F, cfg,
                                    debug=debug))


@functools.lru_cache(maxsize=16)
def _jitted_chunk(calib: Calib, f_bytes: bytes, cfg: PipelineConfig,
                  chunk: int):
    """Compiled K-frames-per-dispatch step (see _jitted_step)."""
    F = np.frombuffer(f_bytes, np.float64).reshape(3, 3)
    return jax.jit(build_frame_chunk(calib, F, cfg, chunk))


@dataclasses.dataclass
class SequenceResult:
    poses: np.ndarray        # (T, 4, 4) cumulative poses (frame 0 = I)
    motions: np.ndarray      # (T, 6) per-frame motion vectors
    frame_ok: np.ndarray     # (T,) bool
    stats: list              # per-frame dicts (match counts etc.)
    processed: int = 0       # frames computed THIS run (excludes
    #                          checkpoint-restored ones) — the honest
    #                          denominator for throughput


def run_stereo_sequence(frames: Iterable, P1, P2,
                        cfg: PipelineConfig = PipelineConfig(),
                        seed: int = 0,
                        on_frame=None, dbg_dir=None,
                        checkpoint=None,
                        fingerprint_scope: str = "",
                        chunk: int = 1) -> SequenceResult:
    """Host driver: stream stereo pairs through the jitted step.

    The analog of the reference `sequence_odometry` loop + the `kitti`
    driver glue (src/kitti.cpp:111-116): calibration is derived from P1/P2
    exactly as viso.cpp:1183-1187, F from F_from_P (viso.cpp:1176-1180).

    Args:
      frames: iterable of (im_left, im_right) uint8/float arrays (H, W).
      P1, P2: 3x4 rectified projection matrices.
      on_frame: optional callback(frame_index, FrameOutput) for metrics.
      dbg_dir: write per-frame debug artifacts here (C17; the reference's
        param.save_debug + dbg_dir, src/viso.cpp:1232-1310).
      checkpoint: optional utils.checkpoint.CheckpointManager.  The loop
        state is snapshotted every `checkpoint.every` frames and, when a
        checkpoint with a matching config fingerprint exists, the run
        resumes after its last frame (already-done frames are skipped;
        per-frame keys are fold_in(key, t), so resume is bit-exact).
        Reference has no analog — it writes poses only at the end
        (src/kitti.cpp:111-116).  SURVEY.md §5.4.
      fingerprint_scope: string identifying the input slice (e.g. the
        KITTI begin/end range); a checkpoint written under a different
        scope is rejected instead of silently misaligning frames.
      chunk: frames per device dispatch (build_frame_chunk).  >1 scans
        `chunk` per-frame steps inside one launch — bitwise-identical
        outputs (tested), K× fewer dispatches; results still stream
        through the same pending-futures path, just K at a time.  Debug
        runs (``dbg_dir``) force per-frame dispatch: the artifact writer
        reads every frame's tensors back anyway, so there is nothing to
        amortize.  The tail of a sequence shorter than the next multiple
        of `chunk` runs through the per-frame step.
    """
    from libviso_tpu.utils.debug_viz import DebugDumper

    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    debug = dbg_dir is not None
    step = _jitted_step(calib, np.ascontiguousarray(F).tobytes(), cfg,
                        debug)
    key = jax.random.PRNGKey(seed)
    dumper = DebugDumper(dbg_dir)

    state = empty_state(cfg)
    motions, oks, stats = [], [], []
    t0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_tpu.utils.checkpoint import (
            Checkpoint,
            config_fingerprint,
        )

        fingerprint = config_fingerprint(cfg, seed,
                                         scope=fingerprint_scope)
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: checkpoint was "
                    f"written with different cfg/seed/scope "
                    f"({ck.fingerprint} != {fingerprint})")
            treedef = jax.tree_util.tree_structure(state)
            state = jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(leaf) for leaf in ck.state_leaves])
            motions = [m for m in ck.motions]
            oks = [bool(o) for o in ck.oks]
            stats = list(ck.stats)
            t0 = ck.next_frame

    def _snapshot(next_frame):
        from libviso_tpu.utils.checkpoint import Checkpoint

        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
        checkpoint.save(Checkpoint(
            next_frame=next_frame,
            motions=np.stack(motions) if motions else np.zeros((0, 6)),
            oks=np.asarray(oks, bool),
            state_leaves=leaves,
            stats=stats,
            fingerprint=fingerprint,
        ))

    start = 0
    if t0 and hasattr(frames, "skipped"):
        # IO-aware skip: don't decode frames the checkpoint already covers
        frames = frames.skipped(t0)
        start = t0
    prev_host = None

    # Device outputs accumulate as futures and materialize lazily (at
    # checkpoints and at the end): reading out.ok inside the loop would
    # force a full host<->device round-trip per frame and serialize the
    # async dispatch pipeline that streaming throughput depends on.
    pending = []

    def _flush():
        for ft, out in pending:
            ok = bool(out.ok) and ft != 0  # reference skips frame 0
            tr = np.asarray(out.tr)
            # motion jump vs the previous accepted motion (weighted
            # 6-dof, rotations x10): the dominant-mover health signal —
            # a contested RANSAC vote flips between motion modes frame
            # to frame (measured jumps 0.4-0.5 in locked truck regimes
            # vs ~0.05 smooth driving; docs/realism.md "Dominant
            # movers").  Host-side only: no graph change, no sync cost
            # beyond the flush's own.
            jump = 0.0
            if ok and motions and oks and oks[-1]:
                # f64 subtraction: keeps the stat bit-identical across
                # checkpoint resume (restored motions are exact f64
                # copies of the live f32 values; an f32-f32 subtraction
                # rounds where the resumed f32-f64 one would not)
                d = (np.asarray(tr, np.float64)
                     - np.asarray(motions[-1], np.float64)) * np.array(
                    [10.0, 10.0, 10.0, 1.0, 1.0, 1.0])
                jump = float(np.linalg.norm(d))
            motions.append(tr)
            oks.append(ok)
            stats.append({
                "frame": ft,
                "ok": ok,
                "num_kp1": int(out.num_kp1),
                "num_lr": int(out.num_lr),
                "num_circle": int(out.num_circle),
                "num_inliers": int(out.num_inliers),
                "reproj_rms": float(out.rms),
                "sharpness": float(out.sharpness),
                "motion_jump": jump,
            })
        pending.clear()

    # chunked dispatch: buffer K frames, run them as one launch.  Debug
    # runs stay per-frame (the artifact writer syncs every frame anyway).
    use_chunk = chunk > 1 and not debug
    cstep = _jitted_chunk(calib, np.ascontiguousarray(F).tobytes(), cfg,
                          chunk) if use_chunk else None
    buf = []  # [(t, im1_dev, im2_dev)] pending group

    # Per-frame fold_in keys are prefetched in blocks of 8 chunks: building
    # them eagerly per group (fold_in + stack in the dispatch path) puts
    # small eager dispatches between the chunked launches.  One vmapped
    # fold_in per block keeps the key computation off the
    # critical path; slices of the block are lazy device views.
    _kblock = {"start": -1, "keys": None}

    def _keys_for(ts):
        span = chunk * 8
        if _kblock["keys"] is None or not (
                _kblock["start"] <= ts[0] and
                ts[-1] < _kblock["start"] + span):
            _kblock["start"] = ts[0]
            _kblock["keys"] = jax.vmap(
                lambda i: jax.random.fold_in(key, i))(
                    jnp.arange(ts[0], ts[0] + span, dtype=jnp.uint32))
        off = ts[0] - _kblock["start"]
        return _kblock["keys"][off:off + len(ts)]

    def _run_buf():
        nonlocal state
        ts = [b[0] for b in buf]
        lefts = jnp.stack([b[1] for b in buf])
        rights = jnp.stack([b[2] for b in buf])
        keys = _keys_for(ts)
        state, outs = cstep(state, lefts, rights, keys)
        for i, ft in enumerate(ts):
            # lazy per-frame slices: device futures, no host sync here
            out_i = jax.tree_util.tree_map(lambda x, i=i: x[i], outs)
            pending.append((ft, out_i))
            if on_frame is not None:
                on_frame(ft, out_i)
        buf.clear()
        if checkpoint is not None and (
                (ts[-1] + 1) // checkpoint.every > ts[0] // checkpoint.every):
            # a snapshot boundary fell inside this chunk: snapshot at the
            # chunk end (resume stays bit-exact; only the cadence shifts)
            _flush()
            _snapshot(ts[-1] + 1)

    for t, (im1, im2) in enumerate(frames, start=start):
        if t < t0:  # already covered by the restored checkpoint
            continue
        # ship uint8 when possible (4x less host->device traffic); the
        # detector casts on-device
        im1 = jnp.asarray(im1)
        im2 = jnp.asarray(im2)
        if use_chunk:
            buf.append((t, im1, im2))
            if len(buf) == chunk:
                _run_buf()
            continue
        prev_state = state
        if debug:
            state, out, dbg = step(state, im1, im2,
                                   jax.random.fold_in(key, t))
            from libviso_tpu.ops.matching import MatchResult

            mlr = MatchResult(idx=dbg.match_lr,
                              dist=jnp.zeros_like(dbg.kp1.response),
                              valid=dbg.match_lr >= 0)
            dumper.frame(
                t, np.asarray(im1), np.asarray(im2), dbg.kp1, dbg.kp2,
                mlr,
                prev=(prev_host[0], prev_host[1], prev_state.kp1,
                      prev_state.kp2) if prev_host else None,
                circ=dbg.circle if t > 0 else None,
                predict=dbg.predict if t > 0 else None,
                obs=dbg.obs if t > 0 else None,
                inliers=dbg.inliers if t > 0 else None)
            prev_host = (np.asarray(im1), np.asarray(im2))
        else:
            state, out = step(state, im1, im2, jax.random.fold_in(key, t))
        pending.append((t, out))
        if on_frame is not None:
            on_frame(t, out)
        if checkpoint is not None and (t + 1) % checkpoint.every == 0:
            _flush()
            _snapshot(t + 1)

    for ft, im1, im2 in buf:
        # tail shorter than one chunk: finish with the per-frame step
        # (same graph as chunk=1, same keys — bitwise identical result)
        state, out = step(state, im1, im2, jax.random.fold_in(key, ft))
        pending.append((ft, out))
        if on_frame is not None:
            on_frame(ft, out)
    buf.clear()

    _flush()
    if checkpoint is not None and motions:
        _snapshot(len(motions))  # final snapshot so a rerun is a no-op

    motions = np.stack(motions) if motions else np.zeros((0, 6))
    oks_arr = np.asarray(oks, bool)
    if len(motions):
        from libviso_tpu.geometry.se3 import pose_vector_to_matrix
        Ts = pose_vector_to_matrix(jnp.asarray(motions))
        poses = np.asarray(chain_motions(Ts, jnp.asarray(oks_arr)))
    else:
        poses = np.zeros((0, 4, 4))
    return SequenceResult(poses=poses, motions=motions, frame_ok=oks_arr,
                          stats=stats, processed=len(motions) - t0)
