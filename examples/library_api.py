"""Minimal library-API tour (no CLI): stereo VO, windowed BA, mono SfM.

The reference exposes its engine as C++ calls (sequence_odometry,
calibratedSFM — src/viso.h:105-121); these are the Python equivalents.
Runs end-to-end on the synthetic renderer in ~a minute on CPU:

    python examples/library_api.py                       # CPU
    VISO_EXAMPLE_PLATFORM=gpu python examples/library_api.py
"""

import os
import sys

# script-mode `python examples/library_api.py` puts examples/ on
# sys.path, not the repo root — add it so the documented invocation works
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# pick the platform on the live config before any device is touched
jax.config.update("jax_platforms",
                  os.environ.get("VISO_EXAMPLE_PLATFORM", "cpu"))

import numpy as np

from libviso_tpu.config import PipelineConfig
from libviso_tpu.pipeline.stereo import run_stereo_sequence
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.utils.metrics import ate_rmse

# --- data: any iterable of (left, right) uint8 (H, W) arrays works;
# io.kitti.StereoImageStream streams a KITTI sequence with native
# prefetch.  Here: the geometry-true synthetic renderer.
seq = generate_sequence(num_frames=10, num_points=400, seed=3,
                        width=416, height=160)

# --- stereo VO (reference sequence_odometry, viso.cpp:1167-1330):
cfg = PipelineConfig()  # all reference defaults, cited field by field
res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0)
print(f"stereo: solved {int(res.frame_ok.sum())}/{len(res.poses) - 1}, "
      f"ATE {ate_rmse(res.poses, seq.gt_poses):.4f} m")
# res.poses (T,4,4) cumulative; res.stats per-frame dicts incl. the
# `sharpness` health signal (docs/realism.md).

# --- sliding-window bundle adjustment (beyond-reference):
from libviso_tpu.pipeline.windowed import run_windowed_ba

wres = run_windowed_ba(list(seq.frames), seq.P1, seq.P2, cfg,
                       window=6, stride=3, seed=0)
print(f"windowed BA: ATE {ate_rmse(wres.poses, seq.gt_poses):.4f} m "
      f"({len(wres.window_costs)} windows)")

# --- monocular SfM (completes the reference's unfinished calibratedSFM,
# viso.cpp:1332-1398): 5-point E + recoverPose + relative scale.
from libviso_tpu.pipeline.mono import run_mono_sequence

K = seq.P1[:, :3]
mres = run_mono_sequence([l for l, _ in seq.frames], K,
                         cfg=PipelineConfig.mono(), seed=0)
print(f"mono: solved {int(mres.frame_ok.sum())}/{len(mres.poses) - 1} "
      f"(trajectory up to one global scale)")

# --- mono Sim(3) loop back-end (beyond-reference, r5): same call
# shape, plus keyframing and scale-drift-aware loop closure (Umeyama
# landmark-cloud verification + annealed Sim(3) pose graph).  On this
# short straight drive no revisit exists, so loops=[] and the poses
# fall back to the open chain — the closure path itself is measured in
# benchmarks/mono_sim3_battery.py and tests/test_sim3.py.
from libviso_tpu.pipeline.mono_loop import run_mono_sim3_loop

sres = run_mono_sim3_loop([l for l, _ in seq.frames], K,
                          cfg=PipelineConfig.mono(), seed=0,
                          keyframe_every=2, min_gap=3)
print(f"mono sim3: {len(sres.kf_frames)} keyframes, "
      f"{len(sres.loops)} loop edges")

# --- multi-stream serving (beyond-reference): S sequences advanced per
# device dispatch; per-stream results match solo runs (discrete
# decisions exactly, motions to f32 float noise).
from libviso_tpu.pipeline.multistream import run_multistream

seq_b = generate_sequence(num_frames=len(seq.frames), num_points=300,
                          width=seq.frames[0][0].shape[1],
                          height=seq.frames[0][0].shape[0], seed=9)
multi = run_multistream([seq.frames, seq_b.frames],
                        [seq.P1, seq_b.P1], [seq.P2, seq_b.P2], cfg,
                        seeds=[0, 1])
print(f"serving: {len(multi)} streams, solved "
      f"{[int(r.frame_ok.sum()) for r in multi]}")

# --- photograph-like oracle (docs/realism.md "Textured-world
# renderer"): dense ray-cast street frames, same SyntheticSequence
# contract — drop-in for any driver above.
from libviso_tpu.synthetic_world import generate_world_sequence

wseq = generate_world_sequence(num_frames=4, seed=0, width=320,
                               height=128)
wres2 = run_stereo_sequence(wseq.frames, wseq.P1, wseq.P2, cfg, seed=0)
print(f"world: solved {int(wres2.frame_ok.sum())}/{len(wres2.poses) - 1}, "
      f"ATE {ate_rmse(wres2.poses, wseq.gt_poses):.4f} m")

# --- composed back-end (r5): windowed BA locally + pose-graph loop
# closure globally over ONE front-end pass (pipeline/ba_loop.py;
# measured vs its parts in benchmarks/ba_loop_world_battery.py).
from libviso_tpu.config import BAConfig
from libviso_tpu.pipeline.ba_loop import run_windowed_ba_loop

cres = run_windowed_ba_loop(list(seq.frames), seq.P1, seq.P2, cfg,
                            ba=BAConfig(window=4, stride=2),
                            keyframe_every=3, min_gap=4, min_matches=20,
                            min_inliers=10, seed=0)
print(f"composed BA+loop: ATE {ate_rmse(cres.poses, seq.gt_poses):.4f} m"
      f" ({len(cres.loops)} loop edges, "
      f"{len(cres.window_costs)} BA windows)")

assert ate_rmse(res.poses, seq.gt_poses) < 0.1
print("ok")
