"""Command-line drivers (SURVEY.md C1, C3 driver glue).

Python analog of the reference executables:

  kitti driver (src/kitti.cpp:79-118):
    python -m libviso_tpu.cli kitti RESULT_SHA SEQ [BEGIN END]
      --kitti-home $KITTI_HOME (env fallback, same as the reference)
    reads sequences/<seq>/calib.txt + image_{0,1}/%06d.png, runs stereo
    odometry, writes results/<seq>/<sha>/data/<seq>.txt in devkit format.

  mono driver (src/calib_sfm.cpp:53-67):
    python -m libviso_tpu.cli mono --image-mask 'img-%04d.jpg' --calib ...

  synthetic smoke run:
    python -m libviso_tpu.cli synth --frames 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_cfg_flags(parser):
    """Pipeline-tuning flags shared by the kitti and synth subcommands."""
    parser.add_argument(
        "--metric", default=None, choices=["l1", "l2", "l2q8"],
        help="descriptor distance: l2 (the config default) is one "
             "matrix product per match problem, with trajectory-"
             "equivalent matches (tests/test_matcher_equivalence.py); "
             "l2q8 = int8-quantized descriptors, integer product; l1 = "
             "strict reference parity (NORM_L1, src/viso.cpp:989)")
    parser.add_argument(
        "--hyp", default=None, choices=["gn", "procrustes"],
        help="RANSAC hypothesis estimator: procrustes = closed-form "
             "Kabsch init + short polish (the config default); gn = the "
             "reference's GN-from-zero fit (strict hypothesis-"
             "distribution parity)")
    parser.add_argument(
        "--subpixel", action="store_true",
        help="quadratic subpixel corner refinement (beyond-reference: "
             "~2x lower ATE on subpixel-rendered frames; its frame-time "
             "cost on the GPU is not measured)")
    parser.add_argument(
        "--pyramid", type=int, default=None, metavar="L",
        help="multi-scale detection over L pyramid levels "
             "(beyond-reference)")
    parser.add_argument(
        "--sharpen", type=float, default=None, metavar="SIGMA",
        help="unsharp-mask preconditioner for defocused imagery "
             "(beyond-reference): Gaussian sigma in px; restores the "
             "silent heavy-blur failure regime (measured blur-sigma-3 "
             "ATE 0.60 -> 0.08 m at --sharpen 3; docs/realism.md). "
             "Enable when the per-frame `sharpness` stat collapses")
    parser.add_argument(
        "--sharpen-amount", type=float, default=None, metavar="A",
        help="high-pass gain for --sharpen (default 4.0)")
    parser.add_argument(
        "--sharpen-auto", action="store_true",
        help="with --sharpen: apply the mask only on frames whose "
             "in-graph blur metric says they are defocused (sharp "
             "frames are bit-exact no-ops; safe to leave on)")
    parser.add_argument(
        "--chunk", type=int, default=1, metavar="K",
        help="frames per device dispatch (beyond-reference): K>1 scans "
             "K per-frame steps inside one launch — bitwise-identical "
             "trajectory, K-times fewer dispatches; pays where launch "
             "overhead rivals frame compute (small frames).  Results "
             "arrive K frames at a time; debug runs force K=1")
    parser.add_argument(
        "--nms", type=int, default=None, metavar="R",
        help="non-max suppression radius in px before the per-bin "
             "top-k (beyond-reference): keeps only local maxima so one "
             "strong corner's neighbors stop eating budget slots; "
             "spreads the detection budget over distinct corners "
             "(keyframe/loop-closure workloads). 0 = reference parity "
             "(raw nth_element winners, src/viso.cpp:961-963)")
    parser.add_argument(
        "--keep-on-failure", action="store_true",
        help="transient-dropout recovery (beyond-reference): on a failed "
             "solve, keep the last good frame's features as the match "
             "target so the next frame recovers the spanning motion "
             "(measured: one black frame, ATE 1.11 -> 0.29 m; streaming "
             "mode only, docs/realism.md)")


def _device_fields():
    """``platform`` and ``device_kind`` for a run summary, so a CPU run
    can never pass for an accelerator run."""
    from libviso_tpu.parallel.distributed import describe

    d = describe()
    return {"platform": d["platform"], "device_kind": d["device_kind"]}


def _add_health_flags(parser):
    """Run-level health-alarm thresholds (docs/operations.md; shared by
    every driver that prints a `health` block)."""
    from libviso_tpu.config import HealthConfig

    d = HealthConfig()
    parser.add_argument(
        "--support-ratio-alarm", type=float,
        default=d.support_ratio_alarm, metavar="R",
        help="alarm when min per-frame num_inliers/num_circle over the "
             "run drops below R (default %(default)s — fired on 17/17 "
             "locked dominant-mover rows, docs/realism.md)")
    parser.add_argument(
        "--motion-jump-alarm", type=float,
        default=d.motion_jump_alarm, metavar="J",
        help="alarm when the max weighted 6-dof delta between "
             "consecutive accepted motions exceeds J (default "
             "%(default)s — mode-flipping capture)")


def _health_cfg(args):
    from libviso_tpu.config import HealthConfig

    return HealthConfig(
        support_ratio_alarm=getattr(args, "support_ratio_alarm",
                                    HealthConfig().support_ratio_alarm),
        motion_jump_alarm=getattr(args, "motion_jump_alarm",
                                  HealthConfig().motion_jump_alarm))


def _apply_cfg_flags(cfg, args):
    # None = flag not given -> keep the config default.  The values are
    # applied UNCONDITIONALLY when given (comparing against a hard-coded
    # default here silently breaks whenever the config default moves).
    import dataclasses

    if getattr(args, "metric", None) is not None:
        cfg = cfg.with_metric(args.metric)
    if getattr(args, "hyp", None) is not None:
        cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac,
                                            hypothesis_method=args.hyp))
    det = {}
    if getattr(args, "subpixel", False):
        det["subpixel"] = True
    if getattr(args, "pyramid", None) is not None:
        det["pyramid_levels"] = args.pyramid
    if getattr(args, "sharpen", None) is not None:
        det["sharpen_sigma"] = args.sharpen
    if getattr(args, "sharpen_amount", None) is not None:
        det["sharpen_amount"] = args.sharpen_amount
    if getattr(args, "sharpen_auto", False):
        det["sharpen_auto"] = True
        # --sharpen-auto alone must protect, not silently no-op: default
        # to the measured-best mask (docs/realism.md, sigma=3/amount=4);
        # an explicit contradictory --sharpen 0 still errors in config
        det.setdefault("sharpen_sigma", 3.0)
    if getattr(args, "nms", None) is not None:
        det["nms_radius"] = args.nms
    if det:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector, **det))
    if getattr(args, "keep_on_failure", False):
        cfg = dataclasses.replace(cfg, keep_features_on_failure=True)
    return cfg


def _cmd_kitti(args):
    from libviso_tpu.parallel.distributed import initialize_from_env

    initialize_from_env()  # multi-host launch contract (SURVEY.md P7)

    # Multi-sequence convenience: 'kitti sha 00,01,02' runs each sequence
    # in turn inside ONE process — identical image shapes hit the jit
    # cache, so sequences after the first skip compilation entirely.
    if "," in args.seq:
        import copy

        for seq in args.seq.split(","):
            sub = copy.copy(args)
            sub.seq = seq
            _cmd_kitti(sub)
        return

    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.io.kitti import (
        StereoImageStream,
        kitti_sequence_paths,
        load_calib,
        save_poses_kitti,
    )
    from libviso_tpu.pipeline import run_stereo_sequence
    from libviso_tpu.utils.metrics import MetricsLogger, health_summary

    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    paths = kitti_sequence_paths(kitti_home, args.seq)
    P1, P2 = load_calib(paths["calib"])
    stream = StereoImageStream(
        os.path.join(paths["image_0"], "%06d.png"),
        os.path.join(paths["image_1"], "%06d.png"),
        begin=args.begin, end=args.end,
    )
    result_dir = os.path.join(kitti_home, "results", args.seq,
                              args.result_sha)
    os.makedirs(result_dir, exist_ok=True)

    cfg = _apply_cfg_flags(PipelineConfig(), args)
    if args.keep_on_failure and args.ba_window > 0:
        # fail at the argv edge: build_batched_odometry would raise the
        # same incompatibility only AFTER the whole sequence is decoded
        sys.exit("--keep-on-failure is a streaming-mode feature and "
                 "cannot combine with --ba-window (the batched windows "
                 "match all frame pairs in parallel)")
    extra = {}
    t0 = time.perf_counter()
    if args.ba_window > 0 and args.loop_closure:
        # composed back-end (r5): windowed BA locally, pose-graph loop
        # closure globally — pipeline/ba_loop.py
        from libviso_tpu.pipeline.ba_loop import run_windowed_ba_loop

        bl_ckpt = None
        if args.checkpoint_every > 0:
            from libviso_tpu.utils.checkpoint import CheckpointManager

            # separate subdir: the combined snapshot carries window
            # progress AND the keyframe store (own layout)
            bl_ckpt = CheckpointManager(
                os.path.join(result_dir, "checkpoints", "ba_loop"),
                every=args.checkpoint_every)
        stride = (args.ba_stride if args.ba_stride > 0
                  else max(args.ba_window // 2, 1))
        from libviso_tpu.config import BAConfig
        import dataclasses as _dc

        ba_cfg = BAConfig(
            window=args.ba_window, stride=stride,
            outlier_px=args.ba_outlier_px, rerank_px=args.ba_rerank_px,
            prior_strength=args.ba_prior,
            min_cam_obs=args.ba_min_cam_obs,
            gate=not args.ba_no_gate, holdout_modulus=args.ba_holdout)
        if args.ba_gate_margin is not None:
            ba_cfg = _dc.replace(ba_cfg, gate_margin=args.ba_gate_margin)
        res = run_windowed_ba_loop(
            list(stream), P1, P2, cfg, ba=ba_cfg,
            keyframe_every=args.keyframe_every,
            min_gap=args.loop_min_gap,
            min_matches=args.loop_min_matches,
            min_inliers=args.loop_min_inliers,
            robust=args.loop_robust,
            eviction=args.loop_eviction,
            seed=args.seed,
            checkpoint=bl_ckpt,
            fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
            dbg_dir=(os.path.join(result_dir, "dbg")
                     if args.save_debug else None))
        stats = [{"frame": t, "ok": bool(res.frame_ok[t])}
                 for t in range(len(res.poses))]
        stats += [{"loop_candidate": c} for c in (res.candidates or [])]
        extra["ba_windows"] = len(res.window_costs)
        extra["ba_improved"] = sum(
            1 for c in res.window_costs if c[2] and c[1] < c[0])
        extra["loops"] = [
            {"new": le.frame_new, "old": le.frame_old,
             "inliers": le.num_inliers,
             "edge_scale": (float(res.loop_edge_scale[i])
                            if res.loop_edge_scale is not None
                            and i < len(res.loop_edge_scale) else None)}
            for i, le in enumerate(res.loops)]
        extra["graph_cost"] = list(res.graph_cost)
    elif args.ba_window > 0:
        # sliding-window BA mode (BASELINE config 4): needs random access
        # over the window, so frames are staged in memory
        from libviso_tpu.pipeline.windowed import run_windowed_ba

        ba_ckpt = None
        if args.checkpoint_every > 0:
            from libviso_tpu.utils.checkpoint import CheckpointManager

            # `every` counts completed BA WINDOWS in this mode; a
            # separate subdir keeps frame-mode and BA-mode checkpoints
            # (incompatible numbering) independently resumable
            ba_ckpt = CheckpointManager(
                os.path.join(result_dir, "checkpoints", "ba"),
                every=args.checkpoint_every)
        stride = (args.ba_stride if args.ba_stride > 0
                  else max(args.ba_window // 2, 1))
        res = run_windowed_ba(list(stream), P1, P2, cfg,
                              window=args.ba_window,
                              stride=stride,
                              seed=args.seed,
                              checkpoint=ba_ckpt,
                              outlier_px=args.ba_outlier_px,
                              rerank_px=args.ba_rerank_px,
                              prior_strength=args.ba_prior,
                              min_cam_obs=args.ba_min_cam_obs,
                              gate=not args.ba_no_gate,
                              holdout_modulus=args.ba_holdout,
                              gate_margin=args.ba_gate_margin,
                              dbg_dir=(os.path.join(result_dir, "dbg")
                                       if args.save_debug else None),
                              fingerprint_scope=(f"{args.seq}:{args.begin}"
                                                 f":{args.end}"))
        stats = [{"frame": t, "ok": bool(res.frame_ok[t])}
                 for t in range(len(res.poses))]
        extra["ba_windows"] = len(res.window_costs)
        extra["ba_improved"] = sum(
            1 for c in res.window_costs if c[2] and c[1] < c[0])
    elif args.loop_closure:
        from libviso_tpu.pipeline.loop import run_with_loop_closure

        lc_ckpt = None
        if args.checkpoint_every > 0:
            from libviso_tpu.utils.checkpoint import CheckpointManager

            # separate subdir: loop-mode checkpoints carry the keyframe
            # store and are not interchangeable with frame/BA-mode ones
            lc_ckpt = CheckpointManager(
                os.path.join(result_dir, "checkpoints", "loop"),
                every=args.checkpoint_every)
        res = run_with_loop_closure(
            list(stream), P1, P2, cfg,
            keyframe_every=args.keyframe_every,
            min_gap=args.loop_min_gap,
            min_matches=args.loop_min_matches,
            min_inliers=args.loop_min_inliers,
            robust=args.loop_robust,
            eviction=args.loop_eviction,
            seed=args.seed,
            checkpoint=lc_ckpt,
            fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
            dbg_dir=(os.path.join(result_dir, "dbg")
                     if args.save_debug else None))
        stats = [{"frame": t, "ok": bool(res.frame_ok[t])}
                 for t in range(len(res.poses))]
        # every verification attempt lands in metrics.jsonl (threshold
        # tuning needs the rejected candidates, not just the accepted)
        stats += [{"loop_candidate": c} for c in (res.candidates or [])]
        extra["loops"] = [
            {"new": le.frame_new, "old": le.frame_old,
             "inliers": le.num_inliers,
             "edge_scale": (float(res.loop_edge_scale[i])
                            if res.loop_edge_scale is not None
                            and i < len(res.loop_edge_scale) else None)}
            for i, le in enumerate(res.loops)]
        extra["graph_cost"] = list(res.graph_cost)
    else:
        ckpt = None
        if args.checkpoint_every > 0:
            from libviso_tpu.utils.checkpoint import CheckpointManager

            ckpt = CheckpointManager(
                os.path.join(result_dir, "checkpoints"),
                every=args.checkpoint_every)
        res = run_stereo_sequence(
            stream, P1, P2, cfg, seed=args.seed,
            on_frame=None, checkpoint=ckpt,
            fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
            dbg_dir=(os.path.join(result_dir, "dbg")
                     if args.save_debug else None),
            chunk=args.chunk)
        stats = res.stats
    dt = time.perf_counter() - t0
    with MetricsLogger(os.path.join(result_dir, "metrics.jsonl")) as ml:
        for s in stats:
            ml.log(s)
    # run-level health summary (docs/operations.md): the signals an
    # operator should alert on, aggregated from the per-frame stats.
    # Always emitted: the BA/loop modes carry no per-frame sharpness so
    # those keys go null, but failed_frames and the alarm list must
    # never silently disappear from an alert feed (VERDICT r4 #4).
    hc = _health_cfg(args)
    extra["health"] = health_summary(
        stats, res.frame_ok,
        support_ratio_alarm=hc.support_ratio_alarm,
        motion_jump_alarm=hc.motion_jump_alarm)

    # Reference pose list semantics: identity first, then per-frame poses.
    poses_path = os.path.join(result_dir, "data", f"{args.seq}.txt")
    save_poses_kitti(poses_path, res.poses)
    n = len(res.poses)
    # fps over frames computed THIS run: a checkpoint-resumed run must
    # not claim the restored frames' throughput
    n_new = getattr(res, "processed", n)
    print(json.dumps({
        "sequence": args.seq, "frames": n,
        "solved": int(res.frame_ok.sum()),
        "fps": n_new / dt if dt > 0 else None,
        "poses": poses_path, **extra, **_device_fields(),
    }))


def _cmd_synth(args):
    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.pipeline import run_stereo_sequence
    from libviso_tpu.synthetic import generate_sequence
    from libviso_tpu.utils.metrics import ate_rmse, rpe_errors

    if getattr(args, "world_loop", False):
        from libviso_tpu.synthetic_world import generate_plaza_sequence

        seq = generate_plaza_sequence(num_frames=args.frames,
                                      seed=args.seed)
    elif getattr(args, "world", False):
        from libviso_tpu.synthetic_world import generate_world_sequence

        seq = generate_world_sequence(num_frames=args.frames,
                                      seed=args.seed)
    else:
        seq = generate_sequence(num_frames=args.frames, seed=args.seed)
    cfg = _apply_cfg_flags(PipelineConfig(), args)
    t0 = time.perf_counter()
    res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                              seed=args.seed,
                              chunk=args.chunk)
    dt = time.perf_counter() - t0
    terr, rerr = rpe_errors(res.poses, seq.gt_poses)
    print(json.dumps({
        "frames": args.frames,
        "solved": int(res.frame_ok.sum()),
        "ate_rmse_m": ate_rmse(res.poses, seq.gt_poses),
        "rpe_trans_mean_m": float(terr.mean()),
        "rpe_rot_mean_rad": float(rerr.mean()),
        "fps": args.frames / dt, **_device_fields(),
    }))


def _cmd_serve(args):
    """Multi-sequence serving: S KITTI sequences in lockstep on one chip.

    The reference runs one sequence per process (src/kitti.cpp:79-118);
    this driver advances S sequences per device dispatch via the vmapped
    multi-stream step (pipeline/multistream.py) — per-stream results match
    solo runs (same per-frame fold_in keys; discrete decisions exact,
    motions within f32 float noise).  Sequences must share one image
    shape (true for all KITTI odometry sequences of a recording
    platform); frames are staged in memory.
    """
    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.io.kitti import (
        StereoImageStream,
        kitti_sequence_paths,
        load_calib,
        save_poses_kitti,
    )
    from libviso_tpu.pipeline.multistream import run_multistream
    from libviso_tpu.utils.metrics import MetricsLogger, health_summary

    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    if getattr(args, "chunk", 1) > 1:
        # run_multistream dispatches per lockstep timestep; the chunked
        # serving composition exists (pipeline/multistream.py::
        # build_multistream_chunk, bench.py --streams --chunk) but is
        # not wired into this driver — reject rather than ignore
        sys.exit("serve does not take --chunk (streams already amortize "
                 "dispatch; see bench.py --streams --chunk for the "
                 "measured combined mode)")
    seq_names = args.seqs.split(",")
    if len(seq_names) < 2:
        sys.exit("serve wants >=2 sequences (use `kitti` for one)")

    cfg = _apply_cfg_flags(PipelineConfig(), args)
    if args.pool > 0:
        # fleet mode: a fixed-slot StreamPool works through the queue,
        # re-seeding finished slots with the next sequence WITHOUT
        # recompiling (pipeline/multistream.py::StreamPool) — sequences
        # load lazily at attach time, so memory stays O(pool), not
        # O(queue).
        if args.checkpoint_every > 0:
            sys.exit("--pool does not take --checkpoint-every yet (the "
                     "lockstep mode checkpoints; the pool's slot state "
                     "is transient by design)")
        _serve_pool(args, kitti_home, seq_names, cfg)
        return

    frames_l, P1s, P2s = [], [], []
    for name in seq_names:
        paths = kitti_sequence_paths(kitti_home, name)
        P1, P2 = load_calib(paths["calib"])
        stream = StereoImageStream(
            os.path.join(paths["image_0"], "%06d.png"),
            os.path.join(paths["image_1"], "%06d.png"),
            begin=args.begin, end=args.end)
        frames_l.append(list(stream))
        P1s.append(P1)
        P2s.append(P2)
    shapes = {f[0][0].shape for f in frames_l}
    if len(shapes) != 1:
        sys.exit(f"sequences must share one image shape, got {shapes}")

    ckpt = None
    if args.checkpoint_every > 0:
        from libviso_tpu.utils.checkpoint import CheckpointManager

        # one snapshot carries ALL streams; keyed by the result sha under
        # a shared _serve dir (per-sequence result dirs hold poses only)
        ckpt = CheckpointManager(
            os.path.join(kitti_home, "results", "_serve",
                         args.result_sha, "checkpoints"),
            every=args.checkpoint_every)
    t0 = time.perf_counter()
    results = run_multistream(frames_l, P1s, P2s, cfg,
                              seeds=[args.seed + s
                                     for s in range(len(seq_names))],
                              checkpoint=ckpt,
                              fingerprint_scope=(f"{args.seqs}:"
                                                 f"{args.begin}:"
                                                 f"{args.end}"))
    dt = time.perf_counter() - t0

    out = []
    total = 0
    for name, res in zip(seq_names, results):
        result_dir = os.path.join(kitti_home, "results", name,
                                  args.result_sha)
        os.makedirs(result_dir, exist_ok=True)
        with MetricsLogger(os.path.join(result_dir,
                                        "metrics.jsonl")) as ml:
            for s in res.stats:
                ml.log(s)
        poses_path = os.path.join(result_dir, "data", f"{name}.txt")
        save_poses_kitti(poses_path, res.poses)
        # fps over frames computed THIS run (resume must not claim the
        # restored frames' throughput)
        total += getattr(res, "processed", len(res.poses))
        hc = _health_cfg(args)
        out.append({
            "sequence": name, "frames": len(res.poses),
            "solved": int(res.frame_ok.sum()), "poses": poses_path,
            "health": health_summary(
                res.stats, res.frame_ok,
                support_ratio_alarm=hc.support_ratio_alarm,
                motion_jump_alarm=hc.motion_jump_alarm)})
    print(json.dumps({
        "streams": len(seq_names),
        "aggregate_fps": total / dt if dt > 0 else None,
        "sequences": out, **_device_fields(),
    }))


def _serve_pool(args, kitti_home, seq_names, cfg):
    """Fleet serving: work a queue of sequences through a fixed-slot
    StreamPool, writing each sequence's results the moment it finishes
    and re-seeding its slot with the next queued sequence (no
    recompile — the serving-fleet lifecycle, VERDICT r3 #9)."""
    from libviso_tpu.io.kitti import (
        StereoImageStream,
        kitti_sequence_paths,
        load_calib,
        save_poses_kitti,
    )
    from libviso_tpu.pipeline.multistream import StreamPool
    from libviso_tpu.utils.metrics import MetricsLogger, health_summary

    def load(name):
        paths = kitti_sequence_paths(kitti_home, name)
        P1, P2 = load_calib(paths["calib"])
        stream = StereoImageStream(
            os.path.join(paths["image_0"], "%06d.png"),
            os.path.join(paths["image_1"], "%06d.png"),
            begin=args.begin, end=args.end)
        return list(stream), P1, P2

    slots = min(args.pool, len(seq_names))
    pool = StreamPool(cfg, slots=slots)
    queue = list(enumerate(seq_names))     # (global index, name)
    slot_seq = {}                          # slot -> (index, name)
    t0 = time.perf_counter()

    def attach_next(slot):
        idx, name = queue.pop(0)
        frames, P1, P2 = load(name)
        # stream i uses seed+i regardless of slot, matching its solo run
        pool.attach(slot, frames, P1, P2, seed=args.seed + idx)
        slot_seq[slot] = (idx, name)

    out = [None] * len(seq_names)
    total = 0
    for s in range(slots):
        attach_next(s)
    # NB: finished() returns slot indices — 0 is a real slot, so truth-
    # test the list lengths, never `any(...)`.  Finished slots are
    # re-seeded INSIDE the stepping loop: with heterogeneous sequence
    # lengths a drained slot must not idle (re-processing its last frame
    # with discarded outputs) until every other slot finishes (ADVICE r4).
    while len(pool.active()) > 0 or len(pool.finished()) > 0:
        if len(pool.active()) > 0:
            pool.step()
        for s in pool.finished():
            idx, name = slot_seq.pop(s)
            res = pool.detach(s)
            result_dir = os.path.join(kitti_home, "results", name,
                                      args.result_sha)
            os.makedirs(result_dir, exist_ok=True)
            with MetricsLogger(os.path.join(result_dir,
                                            "metrics.jsonl")) as ml:
                for st in res.stats:
                    ml.log(st)
            poses_path = os.path.join(result_dir, "data", f"{name}.txt")
            save_poses_kitti(poses_path, res.poses)
            total += len(res.poses)
            hc = _health_cfg(args)
            out[idx] = {
                "sequence": name, "frames": len(res.poses),
                "solved": int(res.frame_ok.sum()), "poses": poses_path,
                "health": health_summary(
                    res.stats, res.frame_ok,
                    support_ratio_alarm=hc.support_ratio_alarm,
                    motion_jump_alarm=hc.motion_jump_alarm)}
            if queue:
                attach_next(s)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "streams": len(seq_names), "pool": slots,
        "aggregate_fps": total / dt if dt > 0 else None,
        "sequences": out, **_device_fields(),
    }))


def _cmd_mono(args):
    """Monocular SfM driver (calib_sfm.cpp analog).

    Reads a 3x3 K from a text file (3 rows of 3 floats, or a KITTI-style
    P0 row of which the left 3x3 is used) and a printf-style image mask.
    Honors the reference's ``CBT_HOME`` contract (src/calib_sfm.cpp:56-64):
    with the env var set and no explicit flags, the calib is
    ``$CBT_HOME/calib.txt`` and images are ``$CBT_HOME/img-%04d.jpg``
    starting at frame 1 — exactly the reference's defaults.
    """
    import dataclasses

    from libviso_tpu.config import MonoConfig
    from libviso_tpu.pipeline.mono import run_mono_sequence

    cbt_home = os.environ.get("CBT_HOME")
    if args.image_mask is None:
        if not cbt_home:
            sys.exit("either --image-mask or CBT_HOME must be set "
                     "(reference contract, src/calib_sfm.cpp:56)")
        args.image_mask = os.path.join(cbt_home, "img-%04d.jpg")
        if args.begin == 0:
            args.begin = 1  # MonoImageGenerator starts at 1 (calib_sfm.cpp:64)
    if args.calib is None:
        if not cbt_home:
            sys.exit("either --calib or CBT_HOME must be set")
        args.calib = os.path.join(cbt_home, "calib.txt")

    mono = MonoConfig()
    overrides = {}
    if args.sampson_thresh is not None:
        overrides["sampson_thresh"] = args.sampson_thresh
    if args.min_good is not None:
        overrides["min_good"] = args.min_good
    if args.rematch_ratio is not None:
        overrides["rematch_ratio"] = args.rematch_ratio
    if args.hypotheses is not None:
        overrides["num_hypotheses"] = args.hypotheses
    if args.no_scale:
        overrides["scale_propagation"] = False
    overrides["method"] = args.method
    mono = dataclasses.replace(mono, **overrides)

    vals = np.loadtxt(args.calib, dtype=np.float64)
    if vals.size == 12:
        K = vals.reshape(3, 4)[:, :3]
    else:
        K = vals.reshape(3, 3)

    from libviso_tpu.io.kitti import MonoImageStream

    # native C++ prefetch decode (PNG/JPEG) with a threaded PNG fallback —
    # decode overlaps device compute exactly as in the stereo driver
    stream = MonoImageStream(args.image_mask, begin=args.begin,
                             end=args.end)

    t0 = time.perf_counter()
    pcfg = None  # run_mono_sequence defaults to PipelineConfig.mono()
    if args.keep_on_failure:
        from libviso_tpu.config import PipelineConfig

        pcfg = dataclasses.replace(PipelineConfig.mono(),
                                   keep_features_on_failure=True)
    summary = {}
    if getattr(args, "sim3_loop", False):
        from libviso_tpu.pipeline.mono_loop import run_mono_sim3_loop

        res = run_mono_sim3_loop(stream, K, cfg=pcfg, seed=args.seed,
                                 mono=mono, keyframe_every=args.kf_every,
                                 min_gap=args.loop_min_gap)
        summary["loops"] = [
            {"frame_old": le.frame_old, "frame_new": le.frame_new,
             "inliers": le.num_inliers, "scale": round(le.s_rel, 4)}
            for le in res.loops]
        summary["keyframes"] = len(res.kf_frames)
        summary["graph_cost"] = [round(c, 6) for c in res.graph_cost]
    else:
        res = run_mono_sequence(stream, K, cfg=pcfg, seed=args.seed,
                                mono=mono)
    dt = time.perf_counter() - t0
    if args.out:
        from libviso_tpu.io.kitti import save_poses_kitti
        save_poses_kitti(args.out, res.poses)
    n = len(res.poses)
    print(json.dumps({
        "frames": n,
        "solved": int(res.frame_ok.sum()),
        "fps": n / dt if dt else None,
        "poses": args.out,
        **summary, **_device_fields(),
        "note": ("monocular poses are correct up to one global scale "
                 "(relative scale propagated through shared landmarks)"
                 if mono.scale_propagation else
                 "monocular poses are scale-ambiguous (unit-norm steps)"),
    }))


def _cmd_eval(args):
    """Trajectory evaluation (the reference defers this to the external
    KITTI devkit, src/kitti.cpp:49-64; we ship it in-repo per BASELINE.md)."""
    from libviso_tpu.io.kitti import load_poses_kitti
    from libviso_tpu.utils.metrics import (
        ate_rmse,
        kitti_trajectory_errors,
        rpe_errors,
    )

    est = load_poses_kitti(args.est)
    gt = load_poses_kitti(args.gt)
    n = min(len(est), len(gt))
    if n < 2:
        sys.exit("need at least 2 poses in both files")
    est, gt = est[:n], gt[:n]
    terr, rerr = rpe_errors(est, gt, delta=args.delta)
    out = {
        "frames": n,
        "ate_rmse_m": ate_rmse(est, gt, align=args.align),
        "rpe_trans_mean_m": float(terr.mean()),
        "rpe_rot_mean_rad": float(rerr.mean()),
    }
    if args.align != "none":
        out["align"] = args.align
        out["ate_rmse_raw_m"] = ate_rmse(est, gt)
    out.update(kitti_trajectory_errors(est, gt))
    if args.plot:
        from libviso_tpu.utils.debug_viz import save_trajectory

        out["plot"] = save_trajectory(args.plot, est, gt)
    # NaN (e.g. devkit-style errors on clips shorter than the 100 m
    # segment) is not valid strict JSON -> emit null
    out = {k: (None if isinstance(v, float) and np.isnan(v) else v)
           for k, v in out.items()}
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="libviso_tpu")
    p.add_argument(
        "--platform", default=None, metavar="P",
        help="jax platform to run on (e.g. 'cpu' for tests and CPU "
             "runs; default: jax's own choice, the GPU when present). "
             "Global flag: place it BEFORE the subcommand")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="KITTI stereo odometry (kitti.cpp analog)")
    k.add_argument("result_sha")
    k.add_argument("seq")
    k.add_argument("begin", nargs="?", type=int, default=0)
    k.add_argument("end", nargs="?", type=int, default=None)
    k.add_argument("--kitti-home")
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="snapshot loop state every N frames (or every N "
                        "BA windows with --ba-window) under "
                        "results/.../checkpoints and resume from the "
                        "latest matching checkpoint (0 = off)")
    k.add_argument("--ba-window", type=int, default=0, metavar="W",
                   help="refine with sliding-window bundle adjustment of "
                        "W frames, stride W/2 (0 = off)")
    k.add_argument("--ba-stride", type=int, default=0,
                   help="window start spacing (default 0 = window/2; "
                        "stride < window overlaps consecutive windows)")
    k.add_argument("--ba-prior", type=float, default=1.0,
                   help="cross-window marginalization-prior strength: "
                        "each window's overlap motions are anchored at "
                        "the previous window's refined estimates "
                        "(0 = independent windows, round-1 behavior)")
    k.add_argument("--ba-outlier-px", type=float, default=30.0,
                   help="BA stage-1 observation gate on initial "
                        "reprojection error [px]")
    k.add_argument("--ba-rerank-px", type=float, default=2.0,
                   help="BA stage-2 re-gate on coarse-solution "
                        "residuals [px]")
    k.add_argument("--ba-no-gate", action="store_true",
                   help="disable the per-window acceptance gate (round-3 "
                        "always-apply behavior; the gate makes "
                        "--ba-window never-worse on clean imagery by "
                        "rejecting refinements that do not CLEARLY beat "
                        "the VO poses on held-out evidence)")
    k.add_argument("--ba-holdout", type=int, default=0, metavar="M",
                   help="gate population: 0 = all tracked observations "
                        "(default); M>1 = hold every M-th landmark out "
                        "of BA and gate on those only")
    k.add_argument("--ba-gate-margin", type=float, default=None,
                   help="clear-win bar: the MEAN of the two split-half "
                        "paired error ratios (refined/VO) must be <= "
                        "margin (margin < 1; at the noise floor BA "
                        "stays rejected).  Default: BAConfig.gate_margin"
                        " (0.90, r5 calibration)")
    k.add_argument("--ba-min-cam-obs", type=int, default=24,
                   help="min post-gate observations per camera for its "
                        "adjacent motions to take the BA refinement")
    k.add_argument("--loop-closure", action="store_true",
                   help="detect revisits and remove accumulated drift "
                        "with pose-graph optimization (beyond-reference; "
                        "docs/architecture.md).  Combine with "
                        "--ba-window for the composed back-end: "
                        "windowed BA locally, pose-graph closure "
                        "globally (pipeline/ba_loop.py)")
    k.add_argument("--keyframe-every", type=int, default=5,
                   help="loop closure: store a keyframe every N frames")
    k.add_argument("--loop-min-gap", type=int, default=20,
                   help="loop closure: min frame separation for a "
                        "revisit candidate")
    k.add_argument("--loop-min-matches", type=int, default=60,
                   help="loop closure: appearance-match count gate "
                        "(above the aliasing floor)")
    k.add_argument("--loop-min-inliers", type=int, default=30,
                   help="loop closure: refined-verification inlier gate")
    k.add_argument("--loop-robust", default="cauchy",
                   choices=["cauchy", "huber", "none"],
                   help="pose-graph robust kernel on loop edges")
    k.add_argument("--loop-eviction", default="spatial",
                   choices=["spatial", "fifo"],
                   help="full-keyframe-store policy: 'spatial' keeps a "
                        "trajectory coverage (loops longer than the "
                        "store still close); 'fifo' ring-overwrites "
                        "oldest-first")
    k.add_argument("--save-debug", action="store_true",
                   help="write per-frame debug artifacts under "
                        "results/.../dbg (reference param.save_debug)")
    _add_cfg_flags(k)
    _add_health_flags(k)
    k.set_defaults(fn=_cmd_kitti)

    s = sub.add_parser("synth", help="synthetic-sequence smoke run")
    s.add_argument("--frames", type=int, default=20)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--world", action="store_true",
                   help="drive the textured-world renderer instead of "
                        "the sprite oracle: dense perspective-correct "
                        "street frames (docs/realism.md 'Textured-world "
                        "renderer'; slower to render, photograph-like)")
    s.add_argument("--world-loop", action="store_true",
                   help="closed-circuit plaza drive through the world "
                        "renderer (the loop-closure oracle)")
    _add_cfg_flags(s)
    s.set_defaults(fn=_cmd_synth)

    sv = sub.add_parser(
        "serve", help="multi-sequence serving: S KITTI sequences in "
                      "lockstep per device dispatch "
                      "(pipeline/multistream.py)")
    sv.add_argument("result_sha", help="results subdirectory name")
    sv.add_argument("seqs", help="comma-separated sequence names, "
                                 "e.g. 00,01,02 (>=2; one shared image "
                                 "shape)")
    sv.add_argument("--kitti-home", default=None,
                    help="dataset root (default $KITTI_HOME)")
    sv.add_argument("--begin", type=int, default=0)
    sv.add_argument("--end", type=int, default=None)
    sv.add_argument("--seed", type=int, default=0,
                    help="stream s uses seed+s (matches its solo run)")
    sv.add_argument("--pool", type=int, default=0, metavar="N",
                    help="fleet mode: work the sequence list through N "
                         "fixed slots, re-seeding each finished slot "
                         "with the next queued sequence without "
                         "recompiling (StreamPool; sequences load "
                         "lazily, memory O(pool)).  0 = lockstep mode "
                         "(all sequences advance together)")
    sv.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N",
                    help="snapshot the full S-stream state every N "
                         "lockstep timesteps (one checkpoint carries all "
                         "streams; resume is bit-exact)")
    _add_cfg_flags(sv)
    _add_health_flags(sv)
    sv.set_defaults(fn=_cmd_serve)

    m = sub.add_parser("mono", help="monocular SfM (calib_sfm.cpp analog)")
    m.add_argument("--image-mask", default=None,
                   help="printf-style mask, e.g. img-%%04d.jpg (default: "
                        "$CBT_HOME/img-%%04d.jpg, the reference contract)")
    m.add_argument("--calib", default=None,
                   help="3x3 K text file (default: $CBT_HOME/calib.txt)")
    m.add_argument("--begin", type=int, default=0)
    m.add_argument("--end", type=int, default=None)
    m.add_argument("--out", help="KITTI-format pose output path")
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--method", default="5pt", choices=["5pt", "8pt"],
                   help="essential-matrix minimal solver (5pt = reference "
                        "findEssentialMat parity)")
    m.add_argument("--sampson-thresh", type=float, default=None,
                   help="RANSAC Sampson gate in normalized coords "
                        "(default MonoConfig.sampson_thresh = 2e-5)")
    m.add_argument("--min-good", type=int, default=None,
                   help="cheirality gate: min points in front of both "
                        "cameras (default 10)")
    m.add_argument("--rematch-ratio", type=float, default=None,
                   help="Lowe ratio for the epipolar re-match (default .9, "
                        "src/viso.cpp:1386-1390)")
    m.add_argument("--hypotheses", type=int, default=None,
                   help="RANSAC sample count (default: 64 for 5pt, 128 "
                        "for 8pt)")
    m.add_argument("--no-scale", action="store_true",
                   help="disable relative-scale propagation (unit-norm "
                        "steps, the constant-speed assumption)")
    m.add_argument("--keep-on-failure", action="store_true",
                   help="transient-dropout recovery: hold the last good "
                        "frame's features across a failed solve "
                        "(docs/realism.md)")
    m.add_argument("--sim3-loop", action="store_true",
                   help="scale-drift-aware loop closure: Sim(3) pose "
                        "graph over keyframe nodes with landmark-cloud "
                        "Umeyama loop edges (pipeline/mono_loop.py; "
                        "beyond-reference — the reference's mono path "
                        "stops at src/viso.cpp:1393-1396)")
    m.add_argument("--kf-every", type=int, default=4,
                   help="keyframe cadence in frames for --sim3-loop")
    m.add_argument("--loop-min-gap", type=int, default=20,
                   help="min frame separation for a loop candidate")
    m.set_defaults(fn=_cmd_mono)

    e = sub.add_parser("eval", help="ATE/RPE + KITTI devkit-style errors "
                                    "between two pose files")
    e.add_argument("est", help="estimated poses (KITTI 3x4 rows)")
    e.add_argument("gt", help="ground-truth poses (KITTI 3x4 rows)")
    e.add_argument("--delta", type=int, default=1, help="RPE frame gap")
    e.add_argument("--align", default="none", choices=["none", "se3", "sim3"],
                   help="pre-align est to gt before ATE: se3 = Horn rigid "
                        "alignment (devkit-comparable), sim3 = also solve "
                        "scale (monocular trajectories)")
    e.add_argument("--plot", help="write a top-down trajectory PNG here")
    e.set_defaults(fn=_cmd_eval)

    args = p.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.cmd != "eval":
        from libviso_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
