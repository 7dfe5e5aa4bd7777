"""Head-to-head: reference C++ vs libviso_tpu on IDENTICAL world frames.

The strongest real-image evidence this container allows (no KITTI
dataset ships here): render a KITTI-scale textured-world drive
(synthetic_world.py — dense perspective-correct texture, z-buffer
occlusion, mipmapped minification; docs/realism.md), write it in KITTI
sequence format, and run BOTH engines on the same PNGs:

  * the reference C++ `kitti` binary (built by
    benchmarks/reference_baseline/build_reference.sh, src/kitti.cpp:79-118
    contract), and
  * `python -m libviso_tpu.cli kitti` (same argv/env contract).

Both trajectories are scored against the exact ground-truth poses with
the same `utils/metrics.py::ate_rmse`.  Usage:

    python benchmarks/world_head_to_head.py [--frames 20] [--force-render]
        [--texture=facade|brick|foliage|glass|photo]   (r5 classes)

Renders once into $WORLD_H2H_HOME (default /tmp/world_h2h) and reuses the
PNGs on re-runs.  Prints one JSON line per engine plus a summary line.
Round-3 measured results are recorded in docs/realism.md.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOME = os.environ.get("WORLD_H2H_HOME", "/tmp/world_h2h")
SEQ = "98"
REF_BIN = os.environ.get("REF_KITTI_BIN", "/tmp/refbuild/kitti")


def _flag(name, default):
    pref = f"--{name}="
    for a in sys.argv[1:]:
        if a.startswith(pref):
            return a[len(pref):]
    return default


def render(num_frames, texture="facade"):
    from PIL import Image

    from libviso_tpu.synthetic_world import generate_world_sequence

    home = HOME if texture == "facade" else f"{HOME}_{texture}"
    base = os.path.join(home, "sequences", SEQ)
    done = os.path.join(base, ".rendered")
    if os.path.exists(done) and "--force-render" not in sys.argv:
        n = int(open(done).read())
        if n >= num_frames:
            print(f"reusing {n} rendered frames at {base}", file=sys.stderr)
            return base
    os.makedirs(os.path.join(base, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(base, "image_1"), exist_ok=True)
    t0 = time.time()
    seq = generate_world_sequence(
        num_frames=num_frames, seed=0, width=1241, height=376,
        f=718.856, base=0.5371657, speed=0.8, wall_texture=texture)
    print(f"rendered {num_frames} stereo frames in {time.time()-t0:.0f}s",
          file=sys.stderr)
    with open(os.path.join(base, "calib.txt"), "w") as fp:
        fp.write("P0: " + " ".join(f"{v:.9e}" for v in seq.P1.reshape(-1))
                 + "\n")
        fp.write("P1: " + " ".join(f"{v:.9e}" for v in seq.P2.reshape(-1))
                 + "\n")
    for i, (l, r) in enumerate(seq.frames):
        Image.fromarray(l.astype(np.uint8)).save(
            os.path.join(base, "image_0", f"{i:06d}.png"))
        Image.fromarray(r.astype(np.uint8)).save(
            os.path.join(base, "image_1", f"{i:06d}.png"))
    np.save(os.path.join(base, "gt_poses.npy"), seq.gt_poses)
    with open(done, "w") as fp:
        fp.write(str(num_frames))
    return base


def _ate(poses_file, gt):
    from libviso_tpu.io.kitti import load_poses_kitti
    from libviso_tpu.utils.metrics import ate_rmse

    est = load_poses_kitti(poses_file)
    n = min(len(est), len(gt))
    return float(ate_rmse(est[:n], gt[:n])), n


def main():
    num_frames = int(_flag("frames", "20"))
    texture = _flag("texture", "facade")
    base = render(num_frames, texture)
    gt = np.load(os.path.join(base, "gt_poses.npy"))

    home = HOME if texture == "facade" else f"{HOME}_{texture}"
    env = dict(os.environ, KITTI_HOME=home)

    # --- reference C++ (self-times its loop; we also wall-clock it)
    t0 = time.time()
    ref = subprocess.run([REF_BIN, "refworld", SEQ], env=env,
                         capture_output=True, text=True, timeout=3600)
    ref_wall = time.time() - t0
    if ref.returncode != 0:
        print(ref.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"reference binary failed rc={ref.returncode}")
    ref_poses = os.path.join(home, "results", SEQ, "refworld", "data",
                             f"{SEQ}.txt")
    ate_ref, n_ref = _ate(ref_poses, gt)
    print(json.dumps({"engine": "reference_cpp", "ate_rmse_m": ate_ref,
                      "frames": n_ref,
                      "wall_s_incl_io": round(ref_wall, 1)}), flush=True)

    # --- ours (same argv/env contract; platform = whatever jax has,
    # or an explicit JAX_PLATFORMS passed on as --platform).
    plat = ([] if not os.environ.get("JAX_PLATFORMS")
            else ["--platform", os.environ["JAX_PLATFORMS"]])
    t0 = time.time()
    ours = subprocess.run(
        [sys.executable, "-m", "libviso_tpu.cli", *plat, "kitti",
         "oursworld", SEQ], env=env, capture_output=True, text=True,
        timeout=3600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ours_wall = time.time() - t0
    if ours.returncode != 0:
        print(ours.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"cli kitti failed rc={ours.returncode}")
    ours_poses = os.path.join(home, "results", SEQ, "oursworld", "data",
                              f"{SEQ}.txt")
    ate_ours, n_ours = _ate(ours_poses, gt)
    print(json.dumps({"engine": "libviso_tpu", "ate_rmse_m": ate_ours,
                      "frames": n_ours,
                      "wall_s_incl_io": round(ours_wall, 1)}), flush=True)

    print(json.dumps({
        "summary": "world_head_to_head",
        "texture": texture,
        "frames": num_frames,
        "ate_reference_m": round(ate_ref, 4),
        "ate_ours_m": round(ate_ours, 4),
        "ate_ratio_ref_over_ours": round(ate_ref / max(ate_ours, 1e-9), 2),
    }), flush=True)


if __name__ == "__main__":
    main()
