"""Smoke run of the stereo and mono main paths on one NVIDIA GPU.

    python chip_smoke.py          # one GPU: phases 1-8 below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One process owns the card(s).  Phases, each of which must pass:

  1. device report (jax devices, versions, nvidia-smi name + power limit);
     anything but a GPU fails here, before any work;
  2. a 24-frame KITTI-format sequence at 1241x376 (PNG + calib + poses);
  3. ``cli kitti`` stereo odometry, scored with ``cli eval``;
  4. ``cli kitti --ba-window 8 --loop-closure`` (composed back-end);
  5. ``cli serve`` over two such sequences;
  6. ``cli mono`` (5-point) scored with ``cli eval --align sim3``;
  7. the same stereo and mono frames through ``run_stereo_sequence`` and
     ``run_mono_sequence`` on the CPU backend of this process: per-frame
     motions and ATE of the card run against the CPU run;
  8. per-op checks at full width: descriptor gathers bitwise against
     ``take``, the l2 distance matrix against float64, every matcher
     metric against its CPU result, and both pose-graph solvers.

The last stdout line is ``{"ok": true, "device": {...}}``; everything
else comes before it.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Full-width protocol (benchmarks/reference_baseline/README.md): KITTI
# frame size and intrinsics, 900 landmarks, 0.8 m per frame.
FULL = dict(num_frames=24, num_points=900, width=1241, height=376,
            f=718.856, base=0.5371657, speed=0.8)

# --- tolerances (stated once, printed with every comparison) -------------
# Card vs CPU, per-frame relative motion.  Both runs see the same uint8
# frames and per-frame RANSAC keys; they differ only in float summation
# order and transcendental ulps.  Readings on an H100 (24 frames): 1.0e-5 m
# and 4.7e-7 rad per frame, ATE within 2.2e-4 of the CPU's.  A controlled
# departure, the card run with the RANSAC keys of seed 1 (what mis-plumbed
# per-frame keys would give), reads 1.6e-2 m, 5.4e-4 rad and 3.7%.  Each
# limit sits >= 45x above the sound reading and >= 3.7x below the departure.
STEREO_TOL_T = 1e-3      # m
STEREO_TOL_R = 1e-4      # rad
STEREO_TOL_ATE_REL = 0.01  # |ATE_card - ATE_cpu| / ATE_cpu, vs ground truth
ATE_BOUND = 0.15         # m, absolute ATE bound (cli synth contract)
# Mono: motions are compared as rotation angle and translation relative
# to the step length.  Readings on an H100: 2.4e-4 rad, 1.1% and a sim3
# ATE 4% off the CPU's; the departure is the mono geometry's products at
# TF32 (the GPU default): 2.2e-3 rad, 10.5% and 73%.
MONO_TOL_R = 1e-3        # rad
MONO_TOL_T_REL = 0.05    # fraction of the step length
MONO_TOL_ATE_REL = 0.25  # |ATE_card - ATE_cpu| / ATE_cpu (sim3-aligned)
# l2 distances: with the cross term at Precision.HIGHEST the squared
# distance carries f32 rounding only, ~1e-7 of ||a||^2 + ||b||^2 per term
# summed over 128 lanes; TF32 would leave ~5e-4.
L2_REL_TOL = 1e-5
# Matcher card-vs-CPU agreement (fraction of identical match indices).
# l1 and l2q8 distances are exact integer arithmetic, so only the float
# Sampson gate can differ; l2 may also reorder ulp-level near-ties.
MATCH_AGREE = {"l1": 0.999, "l2q8": 0.999, "l2": 0.99}
# Pose graphs (SE(3) and Sim(3)) on a 24-node ring of 20 m radius with
# one loop edge, card vs CPU: an LM solve in f32 of a well-conditioned
# graph; 1 mm is ~1e-4 of the ring's extent.
GRAPH_TOL = 1e-3         # m / rotation-matrix entries
# Four cards vs one: the same program on the same hardware type.
FOUR_TOL = 1e-3          # per motion component (m / rad)


def log(tag, **kw):
    print(f"[{tag}] " + json.dumps(kw, default=float), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def init_jax(require_gpu=True):
    """Import jax with the CPU backend available beside the GPU (phase 7
    and 8 compare against it) and fail unless the default device is a
    GPU: JAX quietly falls back to the CPU when its CUDA plugin fails."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    import jax

    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    dev = jax.devices()[0]
    if require_gpu and dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (jax found {jax.devices()})")
    return jax


# ---------------------------------------------------------------------------
# helpers


def jax_platform():
    import jax

    return jax.devices()[0].platform


def cli_json(argv):
    """Run ``cli.main(argv)`` in-process; return its JSON summary."""
    from libviso_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def rel_motions(poses):
    poses = np.asarray(poses, np.float64)
    return np.einsum("tij,tjk->tik", np.linalg.inv(poses[:-1]), poses[1:])


def motion_deviation(pa, pb):
    """Largest per-frame (translation [m], rotation [rad]) difference of
    the relative motions of two trajectories, plus the step lengths."""
    ma, mb = rel_motions(pa), rel_motions(pb)
    dt = np.linalg.norm(ma[:, :3, 3] - mb[:, :3, 3], axis=1)
    R = np.einsum("tji,tjk->tik", ma[:, :3, :3], mb[:, :3, :3])
    # angle from ||R - I||_F = 2 sqrt(2) sin(angle / 2): well conditioned
    # at small angles, where arccos((trace - 1) / 2) is not
    chord = np.linalg.norm(R - np.eye(3), axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    ang = 2.0 * np.arcsin(np.minimum(chord, 1.0))
    return dt, ang, np.linalg.norm(mb[:, :3, 3], axis=1)


def write_sequence(home, name, seed, size):
    """KITTI layout: sequences/<name>/{image_0,image_1,calib.txt} and
    poses/<name>.txt (ground truth)."""
    from libviso_tpu.io.kitti import save_poses_kitti
    from libviso_tpu.io.png import write_png
    from libviso_tpu.synthetic import generate_sequence

    seq = generate_sequence(seed=seed, **size)
    # every scanline filter in every frame, as adaptive encoders (libpng,
    # Pillow) mix them: the decoder in use must handle all five
    filters = np.arange(size["height"]) % 5
    base = os.path.join(home, "sequences", name)
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(base, cam), exist_ok=True)
    with open(os.path.join(base, "calib.txt"), "w") as f:
        for tag, P in (("P0", seq.P1), ("P1", seq.P2)):
            f.write(f"{tag}: " + " ".join(f"{v:.9e}" for v in
                                          np.ravel(P)) + "\n")
    for i, (left, right) in enumerate(seq.frames):
        write_png(os.path.join(base, "image_0", f"{i:06d}.png"),
                  np.asarray(left).astype(np.uint8), filter_type=filters)
        write_png(os.path.join(base, "image_1", f"{i:06d}.png"),
                  np.asarray(right).astype(np.uint8), filter_type=filters)
    gt = os.path.join(home, "poses", f"{name}.txt")
    save_poses_kitti(gt, seq.gt_poses)
    return seq, gt


def load_frames(home, name):
    from libviso_tpu.io.kitti import StereoImageStream

    base = os.path.join(home, "sequences", name)
    return list(StereoImageStream(os.path.join(base, "image_0", "%06d.png"),
                                  os.path.join(base, "image_1", "%06d.png")))


# ---------------------------------------------------------------------------
# phases


def phase_device(jax):
    import jaxlib

    devs = jax.devices()
    smi = nvidia_smi() if devs[0].platform == "gpu" else "n/a"
    log("device", devices=[str(d) for d in devs],
        platform=devs[0].platform, device_kind=devs[0].device_kind,
        count=len(devs), jax=jax.__version__, jaxlib=jaxlib.__version__)
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def phase_stereo(gt, n):
    t0 = time.perf_counter()
    run = cli_json(["kitti", "smoke", "90"])
    ev = cli_json(["eval", run["poses"], gt])
    log("stereo", solved=run["solved"], frames=run["frames"],
        platform=run["platform"], device_kind=run["device_kind"],
        ate_m=ev["ate_rmse_m"], seconds=time.perf_counter() - t0)
    check(run["platform"] == jax_platform(), "cli kitti ran off the card")
    check(run["solved"] == n - 1, f"stereo solved {run['solved']}/{n - 1}")
    check(ev["ate_rmse_m"] < ATE_BOUND, f"stereo ATE {ev['ate_rmse_m']}")
    return run, ev


def phase_composed(gt, n):
    t0 = time.perf_counter()
    run = cli_json(["kitti", "smokeba", "90", "--ba-window", "8",
                    "--loop-closure"])
    ev = cli_json(["eval", run["poses"], gt])
    log("composed", solved=run["solved"], frames=run["frames"],
        ba_windows=run["ba_windows"], loops=len(run["loops"]),
        platform=run["platform"], ate_m=ev["ate_rmse_m"],
        seconds=time.perf_counter() - t0)
    check(run["platform"] == jax_platform(), "composed ran off the card")
    check(run["solved"] == n - 1, f"composed solved {run['solved']}/{n - 1}")
    check(ev["ate_rmse_m"] < ATE_BOUND, f"composed ATE {ev['ate_rmse_m']}")


def phase_serve(gts, n, stereo_poses):
    from libviso_tpu.io.kitti import load_poses_kitti

    t0 = time.perf_counter()
    run = cli_json(["serve", "smokesv", "90,91"])
    check(run["platform"] == jax_platform(), "serve ran off the card")
    ates = []
    for s, gt in zip(run["sequences"], gts):
        check(s["solved"] == n - 1,
              f"serve {s['sequence']} solved {s['solved']}/{n - 1}")
        ates.append(cli_json(["eval", s["poses"], gt])["ate_rmse_m"])
        check(ates[-1] < ATE_BOUND, f"serve ATE {ates[-1]}")
    # stream 0 runs with the solo run's seed: same motions up to float
    # noise of the batched program
    dt, dr, _ = motion_deviation(
        load_poses_kitti(run["sequences"][0]["poses"]),
        load_poses_kitti(stereo_poses))
    log("serve", streams=run["streams"],
        solved=[s["solved"] for s in run["sequences"]], ate_m=ates,
        vs_solo_max_dt_m=dt.max(), vs_solo_max_dr_rad=dr.max(),
        tol_t_m=STEREO_TOL_T, tol_r_rad=STEREO_TOL_R,
        seconds=time.perf_counter() - t0)
    check(dt.max() <= STEREO_TOL_T and dr.max() <= STEREO_TOL_R,
          "serve stream 0 departs from the solo run")


def phase_mono(home, gt, K, n):
    t0 = time.perf_counter()
    kpath = os.path.join(home, "K.txt")
    np.savetxt(kpath, K)
    out = os.path.join(home, "mono_poses.txt")
    run = cli_json(["mono", "--image-mask",
                    os.path.join(home, "sequences", "90", "image_0",
                                 "%06d.png"),
                    "--calib", kpath, "--out", out])
    ev = cli_json(["eval", out, gt, "--align", "sim3"])
    log("mono", solved=run["solved"], frames=run["frames"],
        platform=run["platform"], ate_sim3_m=ev["ate_rmse_m"],
        seconds=time.perf_counter() - t0)
    check(run["platform"] == jax_platform(), "cli mono ran off the card")
    check(run["solved"] == n - 1, f"mono solved {run['solved']}/{n - 1}")
    return out, ev


def phase_cpu_reference(jax, home, seq, K, stereo, mono_out, mono_ev):
    """Phase 7: the plain drivers pinned to the CPU backend."""
    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.io.kitti import load_poses_kitti
    from libviso_tpu.pipeline import run_stereo_sequence
    from libviso_tpu.pipeline.mono import run_mono_sequence
    from libviso_tpu.utils.metrics import ate_rmse

    frames = load_frames(home, "90")
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = run_stereo_sequence(frames, seq.P1, seq.P2, PipelineConfig())
        mref = run_mono_sequence([f[0] for f in frames], K)
    card = load_poses_kitti(stereo[0]["poses"])
    dt, dr, _ = motion_deviation(card, ref.poses)
    ate_cpu = ate_rmse(ref.poses, seq.gt_poses)
    ate_card = stereo[1]["ate_rmse_m"]
    log("stereo_vs_cpu", cpu_solved=int(ref.frame_ok.sum()),
        max_dt_m=dt.max(), max_dr_rad=dr.max(), ate_card_m=ate_card,
        ate_cpu_m=ate_cpu, tol_t_m=STEREO_TOL_T, tol_r_rad=STEREO_TOL_R,
        ate_rel=abs(ate_card - ate_cpu) / ate_cpu,
        tol_ate_rel=STEREO_TOL_ATE_REL)
    check(dt.max() <= STEREO_TOL_T, f"stereo dt {dt.max()} m")
    check(dr.max() <= STEREO_TOL_R, f"stereo dr {dr.max()} rad")
    check(abs(ate_card - ate_cpu) <= STEREO_TOL_ATE_REL * ate_cpu,
          "stereo ATE drift")

    mcard = load_poses_kitti(mono_out)
    mdt, mdr, step = motion_deviation(mcard, mref.poses)
    rel = mdt / np.maximum(step, 1e-9)
    mate_cpu = ate_rmse(mref.poses, seq.gt_poses, align="sim3")
    log("mono_vs_cpu", cpu_solved=int(mref.frame_ok.sum()),
        max_dr_rad=mdr.max(), max_dt_rel=rel.max(),
        ate_card_m=mono_ev["ate_rmse_m"], ate_cpu_m=mate_cpu,
        ate_rel=abs(mono_ev["ate_rmse_m"] - mate_cpu) / mate_cpu,
        tol_r_rad=MONO_TOL_R, tol_t_rel=MONO_TOL_T_REL,
        tol_ate_rel=MONO_TOL_ATE_REL, seconds=time.perf_counter() - t0)
    check(mdr.max() <= MONO_TOL_R, f"mono dr {mdr.max()} rad")
    check(rel.max() <= MONO_TOL_T_REL, f"mono dt/step {rel.max()}")
    check(abs(mono_ev["ate_rmse_m"] - mate_cpu)
          <= MONO_TOL_ATE_REL * mate_cpu, "mono ATE drift")


def phase_ops(jax, home, seq):
    """Phase 8: per-op checks at full width on the card vs the CPU."""
    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.ops.features import (detect_harris_binned,
                                          extract_descriptors, unsharp_mask)
    from libviso_tpu.ops.matching import _l2_desc_dist, match_frame_triple

    t0 = time.perf_counter()
    cfg = PipelineConfig()
    det = cfg.detector
    cpu = jax.devices("cpu")[0]
    frames = load_frames(home, "90")

    def on_cpu(fn, *args):
        with jax.default_device(cpu):
            return fn(*[np.asarray(a) for a in args])

    @functools.lru_cache(maxsize=None)
    def features(gather):
        dcfg = dataclasses.replace(det, descriptor_gather=gather)

        def fn(im):
            kp = detect_harris_binned(im, dcfg)
            return kp, extract_descriptors(im, kp, dcfg, binned_layout=True)

        return jax.jit(fn)

    sharpen = jax.jit(lambda im: unsharp_mask(im, 3.0, 4.0))
    img_u8 = frames[1][0].astype(np.float32)
    img_fl = np.asarray(sharpen(img_u8))
    check(np.any(img_fl != np.round(img_fl)), "sharpened image is integral")
    gathers = {"uint8": ("onehot", "take", "onehot_i8"),
               "sharpen": ("onehot", "take")}
    for name, img in (("uint8", img_u8), ("sharpen", img_fl)):
        ref_take = np.asarray(features("take")(img)[1])
        res = {}
        for g in gathers[name]:
            card = np.asarray(features(g)(img)[1])
            host = np.asarray(on_cpu(features(g), img)[1])
            res[g] = dict(bitwise_vs_take=bool(np.array_equal(card,
                                                              ref_take)),
                          bitwise_vs_cpu=bool(np.array_equal(card, host)))
            check(res[g]["bitwise_vs_take"], f"{name}/{g} gather != take")
            check(res[g]["bitwise_vs_cpu"], f"{name}/{g} card != cpu")
        log("gather", input=name, default=det.descriptor_gather, **res)

    # frame triple: views (1 left, 1 right) against (0 left, 0 right)
    feat = features(det.descriptor_gather)
    kd = [feat(f.astype(np.float32)) for f in
          (frames[1][0], frames[1][1], frames[0][0], frames[0][1])]
    d1 = np.asarray(kd[0][1], np.float64)
    d2 = np.asarray(kd[1][1], np.float64)
    n1 = (d1 * d1).sum(1)
    n2 = (d2 * d2).sum(1)
    sq_ref = np.maximum(n1[:, None] + n2[None, :] - 2.0 * d1 @ d2.T, 0.0)
    dd = np.asarray(jax.jit(_l2_desc_dist)(kd[0][1], kd[1][1]), np.float64)
    err = np.abs(dd * dd - sq_ref) / np.maximum(n1[:, None] + n2[None, :],
                                                1.0)
    log("l2_matrix", shape=list(dd.shape), max_rel_err=err.max(),
        tol=L2_REL_TOL)
    check(err.max() <= L2_REL_TOL, f"l2 distance error {err.max()}")

    F = F_from_P_host(seq.P1, seq.P2)
    args = [x for k, d in kd for x in (k, d)]
    for metric in ("l2", "l2q8", "l1"):
        c = cfg.with_metric(metric)
        triple = jax.jit(lambda *a: match_frame_triple(
            a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7],
            c.stereo_match, c.temporal_match, a[8]))
        card = triple(*args, F)
        with jax.default_device(cpu):
            host = triple(*jax.device_put(args + [F], cpu))
        agree = []
        for mc, mh in zip(card, host):
            ic, ih = np.asarray(mc.idx), np.asarray(mh.idx)
            used = (ic >= 0) | (ih >= 0)
            agree.append(float((ic[used] == ih[used]).mean()))
        log("match", metric=metric, agree=agree, problems=["lr", "l", "r"],
            matched=[int((np.asarray(m.idx) >= 0).sum()) for m in card],
            min_agree=MATCH_AGREE[metric])
        check(min(agree) >= MATCH_AGREE[metric],
              f"{metric} card/cpu agreement {agree}")
    log("ops", seconds=time.perf_counter() - t0)


def ring_graph(T=24, radius=20.0):
    """A closed circle with biased odometry on its first half and one
    exact loop edge (the tests/test_pose_graph.py construction)."""
    from libviso_tpu.geometry.se3 import pose_vector_to_matrix

    th = 2 * np.pi * np.arange(T) / (T - 1)
    gt = np.tile(np.eye(4), (T, 1, 1))
    gt[:, 0, 0] = gt[:, 2, 2] = np.cos(th)
    gt[:, 0, 2], gt[:, 2, 0] = np.sin(th), -np.sin(th)
    gt[:, 0, 3] = radius * np.sin(th)
    gt[:, 2, 3] = radius * (1 - np.cos(th))
    z = np.linalg.inv(gt[:-1]) @ gt[1:]
    bias = np.asarray(pose_vector_to_matrix(
        np.asarray([2e-3, 0.0, 0.0, 0.04, 0.0, 0.02], np.float32)))
    z[:(T - 1) // 2] = z[:(T - 1) // 2] @ bias
    drifted = [gt[0]]
    for k in range(T - 1):
        drifted.append(drifted[-1] @ z[k])
    ei = np.append(np.arange(T - 1), 0).astype(np.int32)
    ej = np.append(np.arange(1, T), T - 1).astype(np.int32)
    ez = np.concatenate([z, (np.linalg.inv(gt[0]) @ gt[-1])[None]])
    w = np.append(np.ones(T - 1), 50.0)
    return (gt.astype(np.float32), np.stack(drifted).astype(np.float32),
            ei, ej, ez.astype(np.float32), w.astype(np.float32))


def phase_graphs(jax):
    """Both pose-graph solvers (LM loops) on the card against the CPU."""
    from libviso_tpu.solvers.pose_graph import optimize_pose_graph
    from libviso_tpu.solvers.pose_graph_sim3 import optimize_sim3_graph

    gt, drifted, ei, ej, ez, w = ring_graph()
    gap0 = np.linalg.norm(drifted[-1, :3, 3] - gt[-1, :3, 3])
    for name, solver in (("se3", optimize_pose_graph),
                         ("sim3", optimize_sim3_graph)):
        fn = jax.jit(lambda *a: solver(*a, iters=15))
        card = fn(drifted, ei, ej, ez, w)
        with jax.default_device(jax.devices("cpu")[0]):
            host = fn(drifted, ei, ej, ez, w)
        dev = np.abs(np.asarray(card.poses) - np.asarray(host.poses)).max()
        gap = np.linalg.norm(np.asarray(card.poses)[-1, :3, 3]
                             - gt[-1, :3, 3])
        log("graph", solver=name, ok=bool(card.ok), gap0_m=gap0,
            gap_m=gap, max_dev_vs_cpu=dev, tol=GRAPH_TOL)
        check(bool(card.ok) and gap < 0.2 * gap0, f"{name} graph failed")
        check(dev <= GRAPH_TOL, f"{name} graph card vs cpu {dev}")


def phase_four(jax, size):
    """--four: sequence-chunk DP and stream-sharded serving on 4 cards,
    each against the same program on one card."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libviso_tpu.config import Calib, PipelineConfig
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.parallel import make_mesh, run_sharded_odometry
    from libviso_tpu.parallel.odometry import (_build_stitch_program,
                                               build_chunk_odometry,
                                               chunk_frames_with_halo)
    from libviso_tpu.pipeline.multistream import (build_multistream_step,
                                                  jit_multistream_sharded,
                                                  stack_states)
    from libviso_tpu.pipeline.stereo import empty_state
    from libviso_tpu.synthetic import generate_sequence
    from libviso_tpu.utils.metrics import ate_rmse

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    mesh = make_mesh(n_data=4)
    cfg = PipelineConfig()

    # (a) sequence-chunk DP: 25 frames = 4 chunks of 6 motions
    t0 = time.perf_counter()
    seq = generate_sequence(seed=0, **dict(size, num_frames=25))
    left = np.stack([f[0] for f in seq.frames]).astype(np.uint8)
    right = np.stack([f[1] for f in seq.frames]).astype(np.uint8)
    poses4, _ = run_sharded_odometry(mesh, seq.P1, seq.P2, left, right, cfg)
    calib = Calib.from_projections(seq.P1, seq.P2)
    program = jax.jit(_build_stitch_program(
        build_chunk_odometry(calib, F_from_P_host(seq.P1, seq.P2), cfg)))
    ims1, ims2, nv = chunk_frames_with_halo(left, right, 4)
    data = NamedSharding(mesh, P("data"))
    sharded_in = jax.device_put(jnp.asarray(ims1), data)
    out4, keep4 = program(sharded_in, jax.device_put(jnp.asarray(ims2), data),
                          jax.device_put(jnp.asarray(nv), data),
                          jax.random.PRNGKey(0))
    one = devs[0]
    out1, keep1 = program(*[jax.device_put(jnp.asarray(x), one)
                            for x in (ims1, ims2, nv)],
                          jax.device_put(jax.random.PRNGKey(0), one))
    p4 = np.asarray(out4)[np.asarray(keep4)]
    p1 = np.asarray(out1)[np.asarray(keep1)]
    dt, dr, _ = motion_deviation(p4, p1)
    held = sorted({s.device.id for s in sharded_in.addressable_shards})
    log("four_dp", chunks=4, frames=len(p4), input_devices=held,
        out_devices=sorted(d.id for d in out4.sharding.device_set),
        max_dt_m=dt.max(), max_dr_rad=dr.max(), tol=FOUR_TOL,
        entry_point_equal=bool(np.allclose(poses4, p4, atol=1e-6)),
        ate_vs_gt_m=ate_rmse(p4, seq.gt_poses),
        seconds=time.perf_counter() - t0)
    check(len(held) == 4, "DP input not spread over 4 devices")
    check(max(dt.max(), dr.max()) <= FOUR_TOL, "DP on 4 != on 1")
    check(np.allclose(poses4, p4, atol=1e-6), "run_sharded_odometry drift")

    # (b) stream-sharded serving: 4 streams x 4 timesteps
    t0 = time.perf_counter()
    S, T = 4, 4
    seqs = [generate_sequence(seed=s, **dict(size, num_frames=T))
            for s in range(S)]
    calib4 = np.zeros((S, 4), np.float32)
    Fs = np.zeros((S, 3, 3))
    for s, sq in enumerate(seqs):
        c = Calib.from_projections(sq.P1, sq.P2)
        calib4[s] = [c.f, c.cu, c.cv, c.base]
        Fs[s] = F_from_P_host(sq.P1, sq.P2)

    def drive(step, place):
        states = place(stack_states([empty_state(cfg) for _ in range(S)]))
        trs, oks, out = [], [], None
        for t in range(T):
            im1 = np.stack([sq.frames[t][0] for sq in seqs]).astype(np.uint8)
            im2 = np.stack([sq.frames[t][1] for sq in seqs]).astype(np.uint8)
            ks = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), t)
                            for s in range(S)])
            states, out = step(*place((calib4, Fs)), states,
                               *place((im1, im2, ks)))
            trs.append(np.asarray(out.tr))
            oks.append(np.asarray(out.ok))
        return np.stack(trs), np.stack(oks), out

    tr4, ok4, out = drive(jit_multistream_sharded(mesh, cfg),
                          lambda x: jax.device_put(x, data))
    tr1, ok1, _ = drive(jax.jit(build_multistream_step(cfg)),
                        lambda x: jax.device_put(x, one))
    held = sorted({s.device.id for s in out.tr.addressable_shards})
    dev = np.abs(tr4 - tr1).max()
    log("four_serve", streams=S, steps=T, out_devices=held,
        ok_equal=bool(np.array_equal(ok4, ok1)), max_abs_dtr=dev,
        tol=FOUR_TOL, seconds=time.perf_counter() - t0)
    check(len(held) == 4, "serving output not on 4 devices")
    check(np.array_equal(ok4, ok1), "serving ok flags differ 4 vs 1")
    check(dev <= FOUR_TOL, f"serving motions differ by {dev}")


def main(argv=None, size=None, require_gpu=True):
    argv = sys.argv[1:] if argv is None else argv
    size = size or FULL
    jax = init_jax(require_gpu)
    from libviso_tpu.utils.compile_cache import enable_compile_cache

    t_start = time.perf_counter()
    enable_compile_cache()
    smi = phase_device(jax)
    if "--four" in argv:
        phase_four(jax, size)
    else:
        home = tempfile.mkdtemp(prefix="chip_smoke_")
        old_home = os.environ.get("KITTI_HOME")
        os.environ["KITTI_HOME"] = home
        try:
            n = size["num_frames"]
            seq, gt = write_sequence(home, "90", 0, size)
            _, gt91 = write_sequence(home, "91", 1, size)
            K = np.asarray(seq.P1, np.float64)[:, :3]
            from libviso_tpu import native

            log("sequence", home=home, frames=n,
                shape=[size["height"], size["width"]],
                native_decoder=native.available())
            stereo = phase_stereo(gt, n)
            phase_composed(gt, n)
            phase_serve([gt, gt91], n, stereo[0]["poses"])
            mono_out, mono_ev = phase_mono(home, gt, K, n)
            phase_cpu_reference(jax, home, seq, K, stereo, mono_out,
                                mono_ev)
            phase_ops(jax, home, seq)
            phase_graphs(jax)
        finally:
            if old_home is None:
                os.environ.pop("KITTI_HOME", None)
            else:
                os.environ["KITTI_HOME"] = old_home
            shutil.rmtree(home, ignore_errors=True)
    devs = jax.devices()
    log("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
