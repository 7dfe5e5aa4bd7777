"""libviso_tpu: a JAX visual odometry / SfM engine.

A from-scratch JAX/XLA re-design of the capabilities of the C++
``libviso`` reference (stereo visual odometry on KITTI + monocular calibrated
SfM): Harris-corner detection, Sobel-patch descriptors, epipolar-gated
descriptor matching with circular consistency, RANSAC + Gauss-Newton pose
estimation, and pose chaining — all as fixed-shape, batched, jit-compiled
computations that XLA compiles for one accelerator or a `jax.sharding`
mesh of them.

Layout (mirrors SURVEY.md §2 component inventory):
  ops/        device kernels: harris, sobel descriptors, matching, circle filter
  geometry/   multi-view geometry: SE(3), F/P matrices, triangulation, epipolar
  solvers/    Gauss-Newton reprojection minimizer + batched RANSAC, Procrustes
  pipeline/   per-frame jit step and sequence drivers (stereo VO, mono SfM)
  parallel/   mesh construction, sequence-sharded odometry, windowed BA
  io/         KITTI dataset loading, calibration parsing, pose writing
  utils/      config, metrics, debug artifact dumps
"""

from libviso_tpu.config import (
    Calib,
    DetectorConfig,
    MatchConfig,
    RansacConfig,
    PipelineConfig,
)

__version__ = "0.1.0"

__all__ = [
    "Calib",
    "DetectorConfig",
    "MatchConfig",
    "RansacConfig",
    "PipelineConfig",
    "__version__",
]
