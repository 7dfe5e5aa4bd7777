"""Benchmark: stereo-VO frames/s on one chip, KITTI-sized workload.

Prints ONE JSON line:
  {"metric": "stereo_vo_fps", "value": <frames/s>, "unit": "frames/s",
   "vs_baseline": <ratio>}

Workload: frame-batched stereo odometry (pipeline/batched.py) on synthetic
KITTI-sized (376 x 1241) stereo frames — full detection at 1200 corners,
3 dense 1280x1280 match problems and 64-hypothesis RANSAC+GN per frame —
steady-state (post-compile).

Default mode times chunked streaming (4 frames per dispatch via lax.scan
of the per-frame step — outputs bit-identical to per-frame dispatch) on
pre-staged device frames, so PNG decode and host-to-device transfer are
not counted.  --upload switches to the batched mode that re-ships uint8
frames every step for an end-to-end-including-transfer number.

Flags:
  --mono           monocular SfM mode: per-frame 5-point (or --mono-8pt)
                   pipeline, metric "mono_sfm_fps", vs_baseline against
                   the MEASURED reference calib_sfm (14.98 fps,
                   benchmarks/reference_baseline/run_mono_baseline.py —
                   the reference's loop stops BEFORE pose recovery;
                   ours completes it)
  --chunk=K        frames per dispatch (default 4; 1 = per-frame latency
                   mode, bit-identical outputs either way)
  --streams=S      multi-stream serving mode: S independent sequences
                   advanced per dispatch (aggregate fps; opt-in)
  --upload         batched mode, host->device transfer included
  --metric=l1|l2|l2q8   descriptor metric (default l2, one matrix
                   product per problem; l1 = strict reference parity)
  --hyp=gn|procrustes    RANSAC hypothesis estimator (config default =
                   procrustes: closed-form Kabsch init + short polish,
                   trajectories bit-identical to gn; gn = the
                   reference's GN-from-zero fit)
  --window=N       frames per batched --upload step (default 8)
  --reps=N         timed repetitions (default 30)

Baseline: the reference publishes no numbers (BASELINE.md), so we MEASURED
it: the C++ `kitti` binary built on this machine
(benchmarks/reference_baseline/build_reference.sh) self-reports 0.189 s
per frame = 5.29 frames/s on a KITTI-scale synthetic sequence, debug dumps
off (its hot path is a linear FLANN radius search over ~1.4M candidate
pairs x3 per frame plus 50 x <=100 scalar Gauss-Newton iterations).
BASELINE_FPS = 5.29 is that measured number; vs_baseline = fps / 5.29.
"""

import json
import sys
import time

import numpy as np

BASELINE_FPS = 5.29  # measured: benchmarks/reference_baseline/README.md
# measured: run_mono_baseline.py — the reference calib_sfm loop
# (detect+match+findEssentialMat+rematch; it abandons reconstruction at
# viso.cpp:1393-1396) on the same 1241x376 synthetic frames, debug dumps
# off: 0.0667 s/frame.  (An earlier 0.0716 measurement accidentally
# included 3 debug JPEG writes/frame — the dump patch was missing its
# file write-back; corrected and re-measured.)
MONO_BASELINE_FPS = 14.98


def _flag(name, default):
    pref = f"--{name}="
    for a in sys.argv[1:]:
        if a.startswith(pref):
            return a[len(pref):]
    return default


def _start_watchdog():
    """Fail LOUDLY instead of hanging: after BENCH_TIMEOUT_S (default
    900 s) print a one-JSON-line error and exit."""
    import os
    import threading

    timeout_s = float(os.environ.get("BENCH_TIMEOUT_S", "900"))

    def fire():
        print(json.dumps({
            "metric": "stereo_vo_fps", "value": None, "unit": "frames/s",
            "vs_baseline": None,
            "error": f"no result after {timeout_s:.0f}s",
        }), flush=True)
        os._exit(2)

    t = threading.Timer(timeout_s, fire)
    t.daemon = True
    t.start()
    return t


def _run_mono(reps, chunk, method, first_pass, hyp, watchdog):
    """Monocular SfM throughput: chunked streaming of the per-frame mono
    step (detect -> match -> 5pt/8pt essential RANSAC -> epipolar
    re-match -> recoverPose -> scale propagation) on KITTI-sized frames.
    Same 5-window-median methodology as the stereo modes.
    ``--mono-first-pass=8pt`` runs the cheap solver for the re-match
    gate pass (MonoConfig.first_pass)."""
    import jax
    import jax.numpy as jnp

    from libviso_tpu.config import MonoConfig, PipelineConfig
    from libviso_tpu.pipeline.mono import build_mono_chunk, empty_mono_state
    from libviso_tpu.synthetic import generate_sequence

    mono = MonoConfig(method=method,
                      **({"first_pass": first_pass} if first_pass
                         else {}),
                      **({"num_hypotheses": hyp} if hyp else {}))
    cfg = PipelineConfig.mono()
    n_frames = max(min(reps, 60), 10, chunk)
    seq = generate_sequence(num_frames=n_frames, num_points=900, seed=0,
                            width=1241, height=376, f=718.856,
                            base=0.5371657, speed=0.8)
    K = np.array([[718.856, 0.0, 620.5], [0.0, 718.856, 188.0],
                  [0.0, 0.0, 1.0]])
    frames = [jnp.asarray(l.astype(np.uint8)) for l, _ in seq.frames]
    key = jax.random.PRNGKey(0)
    cstep = jax.jit(build_mono_chunk(K, cfg, chunk, mono=mono))
    n_groups = len(frames) // chunk
    g_per_w = max(1, reps // chunk)
    stacks = [jnp.stack([frames[g * chunk + i] for i in range(chunk)])
              for g in range(n_groups)]

    def keys_for(base):
        return jnp.stack([jax.random.fold_in(key, base + i)
                          for i in range(chunk)])

    kstacks = [keys_for(100 + w * reps + g * chunk)
               for w in range(5) for g in range(g_per_w)]
    jax.block_until_ready(kstacks[-1])
    state = empty_mono_state(cfg)
    state, out = cstep(state, stacks[0], keys_for(0))
    jax.block_until_ready(out)
    window_fps = []
    for w in range(5):
        t0 = time.perf_counter()
        n = 0
        for g in range(g_per_w):
            state, out = cstep(state, stacks[g % n_groups],
                               kstacks[w * g_per_w + g])
            n += chunk
        jax.block_until_ready(out)
        window_fps.append(n / (time.perf_counter() - t0))
    fps = float(np.median(window_fps))
    watchdog.cancel()
    print(json.dumps({
        "metric": "mono_sfm_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / MONO_BASELINE_FPS, 3),
        "value_best_window": round(max(window_fps), 3),
        "mode": (f"mono_{method}_chunk{chunk}"
                 + (f"_fp{first_pass}" if first_pass else "")
                 + (f"_h{hyp}" if hyp else "")),
    }))


def main():
    watchdog = _start_watchdog()
    import jax
    import jax.numpy as jnp

    from libviso_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from libviso_tpu.config import Calib, PipelineConfig
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.pipeline.batched import build_batched_odometry
    from libviso_tpu.pipeline.stereo import build_frame_step, empty_state
    from libviso_tpu.synthetic import generate_sequence

    metric = _flag("metric", "l2")
    hyp = _flag("hyp", None)
    window = int(_flag("window", "8"))
    reps = int(_flag("reps", "30"))
    if "--mono" in sys.argv:
        _run_mono(reps, int(_flag("chunk", "4")),
                  "8pt" if "--mono-8pt" in sys.argv else "5pt",
                  _flag("mono-first-pass", None),
                  int(_flag("mono-hyp", "0")), watchdog)
        return
    # default chunk=4: K frames per dispatch via lax.scan of the SAME
    # per-frame step — outputs bit-identical to K=1 (tested); per-dispatch
    # overhead amortizes over K frames.  --chunk=1 is the per-frame
    # latency mode.  (The right K on a GPU is open: ROADMAP 1.6.)
    chunk = int(_flag("chunk", "4"))
    streams = int(_flag("streams", "1"))
    staged = "--staged" in sys.argv
    streaming = "--upload" not in sys.argv and not staged

    cfg = PipelineConfig().with_metric(metric)
    if hyp is not None:  # always applied when given (config default moves)
        import dataclasses

        cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac,
                                            hypothesis_method=hyp))
    # enough DISTINCT frames that a streaming rep never repeats inputs
    # within a window (every rep of a window sees a different frame up
    # to 60).  `chunk` joins the floor so a chunked run always has at
    # least one full frame group.
    n_frames = max(window, min(reps, 60), 10, chunk)
    seq = generate_sequence(num_frames=n_frames, num_points=900,
                            seed=0, width=1241, height=376, f=718.856,
                            base=0.5371657, speed=0.8)
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = F_from_P_host(seq.P1, seq.P2)
    key = jax.random.PRNGKey(0)

    if streaming:
        # chunk>1 dispatches `chunk` frames per launch (lax.scan of the
        # SAME per-frame step — bit-identical outputs, tested).  Every
        # fold_in key stack is pre-staged (below) so no eager key work
        # sits between timed dispatches.
        from libviso_tpu.pipeline.stereo import build_frame_chunk

        frames = [(jnp.asarray(l.astype(np.uint8)), jnp.asarray(r.astype(np.uint8)))
                  for l, r in seq.frames]
        state = empty_state(cfg)
        if streams > 1:
            # multi-stream serving mode (pipeline/multistream.py): ONE
            # dispatch advances S streams by chunk frames; aggregate
            # fps = S x K x dispatch rate.  Streams view the same
            # pre-staged frames at different phase offsets with
            # per-stream keys, so no two dispatches ever repeat a
            # (frame, key) pair.
            from libviso_tpu.pipeline.multistream import (
                build_multistream_chunk,
                build_multistream_step,
                stack_states,
            )

            S, K = streams, max(1, chunk)
            if K > 1:
                mstep = jax.jit(build_multistream_chunk(cfg, K))
            else:
                mstep = jax.jit(build_multistream_step(cfg))
            calib4 = jnp.asarray(
                np.tile(np.array([calib.f, calib.cu, calib.cv, calib.base],
                                 np.float32), (S, 1)))
            Fs = jnp.asarray(np.tile(np.asarray(F)[None], (S, 1, 1)))
            n_fr = len(frames)

            def im_at(t):  # (S, H, W) or (S, K, H, W) stacks, staged once
                if K == 1:
                    return (jnp.stack([frames[(t + 7 * s) % n_fr][0]
                                       for s in range(S)]),
                            jnp.stack([frames[(t + 7 * s) % n_fr][1]
                                       for s in range(S)]))
                return tuple(
                    jnp.stack([jnp.stack([frames[(t + i + 7 * s) % n_fr][c]
                                          for i in range(K)])
                               for s in range(S)]) for c in (0, 1))

            stacks = [im_at(t * K) for t in range(min(n_fr, 16))]
            skeys = [jax.random.PRNGKey(s) for s in range(S)]

            def keys_at(t):  # (S,) or (S, K) key stacks
                if K == 1:
                    return jnp.stack([jax.random.fold_in(skeys[s], t)
                                      for s in range(S)])
                return jnp.stack([
                    jnp.stack([jax.random.fold_in(skeys[s], t + i)
                               for i in range(K)]) for s in range(S)])

            d_per_w = max(1, reps // K)  # dispatches per window
            kstacks = [keys_at(100 + (w * d_per_w + g) * K)
                       for w in range(5) for g in range(d_per_w)]
            jax.block_until_ready(kstacks[-1])
            mstates = stack_states([empty_state(cfg) for _ in range(S)])
            for t in range(3):
                ls, rs = stacks[t % len(stacks)]
                mstates, out = mstep(calib4, Fs, mstates, ls, rs,
                                     keys_at(t * K))
            jax.block_until_ready(out)
            window_fps = []
            for w in range(5):
                t0 = time.perf_counter()
                n = 0
                for g in range(d_per_w):
                    ls, rs = stacks[g % len(stacks)]
                    mstates, out = mstep(calib4, Fs, mstates, ls, rs,
                                         kstacks[w * d_per_w + g])
                    n += S * K
                jax.block_until_ready(out)
                window_fps.append(n / (time.perf_counter() - t0))
            fps = float(np.median(window_fps))
            fps_best = max(window_fps)
        elif chunk > 1:
            cstep = jax.jit(build_frame_chunk(calib, F, cfg, chunk))
            # pre-staged frame stacks + per-frame fold_in keys, grouped.
            # The key stacks for EVERY timed group are staged before the
            # clock starts: building them eagerly inside the loop
            # (fold_in + stack per group) would put eager dispatches
            # between the timed ones.
            n_groups = len(frames) // chunk
            g_per_w = max(1, reps // chunk)
            lstacks = [jnp.stack([frames[g * chunk + i][0]
                                  for i in range(chunk)])
                       for g in range(n_groups)]
            rstacks = [jnp.stack([frames[g * chunk + i][1]
                                  for i in range(chunk)])
                       for g in range(n_groups)]

            def keys_for(base):
                return jnp.stack([jax.random.fold_in(key, base + i)
                                  for i in range(chunk)])

            kstacks = [keys_for(100 + w * reps + g * chunk)
                       for w in range(5) for g in range(g_per_w)]
            jax.block_until_ready(kstacks[-1])

            state, out = cstep(state, lstacks[0], rstacks[0], keys_for(0))
            jax.block_until_ready(out)

            window_fps = []
            for w in range(5):
                t0 = time.perf_counter()
                n = 0
                for g in range(g_per_w):
                    state, out = cstep(state, lstacks[g % n_groups],
                                       rstacks[g % n_groups],
                                       kstacks[w * g_per_w + g])
                    n += chunk
                jax.block_until_ready(out)
                window_fps.append(n / (time.perf_counter() - t0))
            fps = float(np.median(window_fps))
            fps_best = max(window_fps)
        else:
            step = jax.jit(build_frame_step(calib, F, cfg))
            for t in range(3):
                state, out = step(state, frames[t][0], frames[t][1],
                                  jax.random.fold_in(key, t))
            jax.block_until_ready(out)
            # 5 measurement windows; the HEADLINE value is the MEDIAN
            # window (robust to stalls in both directions).  The best
            # window is reported alongside.
            window_fps = []
            for w in range(5):
                t0 = time.perf_counter()
                n = 0
                for t in range(reps):
                    l, r = frames[t % len(frames)]
                    state, out = step(
                        state, l, r,
                        jax.random.fold_in(key, 100 + w * reps + t))
                    n += 1
                jax.block_until_ready(out)
                window_fps.append(n / (time.perf_counter() - t0))
            fps = float(np.median(window_fps))
            fps_best = max(window_fps)
    elif staged:
        # Whole-window batched odometry on pre-staged device frames: ONE
        # dispatch per `window` frames, so per-dispatch overhead
        # amortizes away.  --upload adds transfer.
        fn = jax.jit(build_batched_odometry(calib, F, cfg))
        T = min(window, len(seq.frames))
        left_d = jnp.asarray(
            np.stack([f[0] for f in seq.frames[:T]]).astype(np.uint8))
        right_d = jnp.asarray(
            np.stack([f[1] for f in seq.frames[:T]]).astype(np.uint8))
        out = fn(left_d, right_d, key)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        n = 0
        for t in range(reps):
            out = fn(left_d, right_d, jax.random.fold_in(key, t))
            n += T
        jax.block_until_ready(out)
        fps = n / (time.perf_counter() - t0)
    else:
        fn = jax.jit(build_batched_odometry(calib, F, cfg))
        left = np.stack([f[0] for f in seq.frames[:window]]).astype(np.uint8)
        right = np.stack([f[1] for f in seq.frames[:window]]).astype(np.uint8)
        left_d = jnp.asarray(left)
        right_d = jnp.asarray(right)
        out = fn(left_d, right_d, key)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        n = 0
        for t in range(reps):
            # re-upload images each rep: host->device transfer is part of
            # the steady-state cost (uint8: 4x less than f32)
            left_d = jnp.asarray(left)
            right_d = jnp.asarray(right)
            out = fn(left_d, right_d, jax.random.fold_in(key, t))
            n += window
        jax.block_until_ready(out)
        fps = n / (time.perf_counter() - t0)

    if "--profile" in sys.argv:
        # Per-kernel roofline report (SURVEY.md §5.1) to stderr so the
        # driver's one-JSON-line stdout contract holds.
        from libviso_tpu.utils.profiling import (
            device_peaks,
            profile_frame_step,
            profile_matcher,
            profile_solver,
        )

        peak_f, peak_b = device_peaks()
        print(f"device: {jax.devices()[0].device_kind} "
              f"peak={peak_f and peak_f / 1e12} TFLOP/s "
              f"bw={peak_b and peak_b / 1e9} GB/s", file=sys.stderr)
        n = cfg.detector.num_slots
        d = cfg.detector.descriptor_dim_padded
        for st in (
            profile_matcher(n, n, d, metric=metric,
                            reps=min(reps, 8)),
            profile_solver(cfg.ransac.num_hypotheses, cfg.ransac.gn_iters,
                           n, reps=min(reps, 8)),
            profile_frame_step(cfg, reps=5),
        ):
            print(st.pretty(), file=sys.stderr)

    line = {
        "metric": "stereo_vo_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }
    if streaming:
        line["value_best_window"] = round(fps_best, 3)
        line["mode"] = (f"serving_streams{streams}x chunk{chunk}".replace(
                            "x ", "_") if streams > 1
                        else f"streaming_chunk{chunk}" if chunk > 1
                        else "streaming_per_frame")
    watchdog.cancel()  # before printing: exactly ONE line either way
    print(json.dumps(line))


if __name__ == "__main__":
    main()
