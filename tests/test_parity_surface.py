"""PARITY.md names concrete symbols for every reference component; this
test pins that surface so refactors cannot silently orphan the map."""

import importlib

import pytest

# (module, symbol) for every "Ours" entry in PARITY.md
SURFACE = [
    # C1 KITTI CLI + IO
    ("libviso_tpu.cli", "main"),
    ("libviso_tpu.io.kitti", "load_calib"),
    ("libviso_tpu.io.kitti", "save_poses_kitti"),
    ("libviso_tpu.io.kitti", "StereoImageStream"),
    # C2 stereo pipeline
    ("libviso_tpu.pipeline.stereo", "build_frame_step"),
    ("libviso_tpu.pipeline.stereo", "build_frontend"),
    ("libviso_tpu.pipeline.stereo", "build_prepare"),
    ("libviso_tpu.pipeline.stereo", "build_solve"),
    ("libviso_tpu.pipeline.stereo", "run_stereo_sequence"),
    # C3 mono
    ("libviso_tpu.pipeline.mono", "run_mono_sequence"),
    ("libviso_tpu.geometry.essential", "eight_point_E"),
    ("libviso_tpu.geometry.essential", "ransac_essential"),
    ("libviso_tpu.geometry.essential", "recover_pose"),
    ("libviso_tpu.geometry.essential", "undistort_points"),
    ("libviso_tpu.geometry.five_point", "five_point_E"),
    # C4/C5 detector + descriptor
    ("libviso_tpu.ops.features", "harris_response"),
    ("libviso_tpu.ops.features", "detect_harris_binned"),
    ("libviso_tpu.ops.features", "sobel_derivatives"),
    ("libviso_tpu.ops.features", "extract_descriptors"),
    # C6 matcher
    ("libviso_tpu.ops.matching", "match_descriptors"),
    ("libviso_tpu.ops.matching", "match_frame_triple"),
    ("libviso_tpu.ops.matching", "match_problem_batch"),
    # C7 epipolar distances
    ("libviso_tpu.geometry.mvg", "sampson_distance"),
    ("libviso_tpu.geometry.mvg", "algebraic_distance"),
    # C8 circle filter
    ("libviso_tpu.ops.circle", "circle_filter"),
    # C9/C10 triangulation
    ("libviso_tpu.geometry.triangulate", "triangulate_rectified"),
    ("libviso_tpu.geometry.triangulate", "triangulate_dlt"),
    # C11/C12 solver
    ("libviso_tpu.solvers.ransac", "ransac_pose"),
    ("libviso_tpu.solvers.gauss_newton", "gauss_newton"),
    ("libviso_tpu.solvers.gauss_newton", "reprojection_errors_sq"),
    # C13 SE(3)
    ("libviso_tpu.geometry.se3", "pose_vector_to_matrix"),
    ("libviso_tpu.geometry.se3", "matrix_to_pose_vector"),
    ("libviso_tpu.geometry.se3", "chain_motions"),
    # C14 Procrustes
    ("libviso_tpu.geometry.procrustes", "solve_rigid_motion"),
    ("libviso_tpu.geometry.procrustes", "ransac_rigid_motion"),
    # C15 MVG library
    ("libviso_tpu.geometry.mvg", "F_from_P"),
    ("libviso_tpu.geometry.mvg", "P_from_KRt"),
    ("libviso_tpu.geometry.mvg", "Camera"),
    ("libviso_tpu.geometry.mvg", "StereoCam"),
    ("libviso_tpu.geometry.mvg", "stereo_rectify"),
    ("libviso_tpu.geometry.mvg", "rectification_warp"),
    # C16 loaders (native runtime)
    ("libviso_tpu.native", "available"),
    # C17 debug viz
    ("libviso_tpu.utils.debug_viz", "DebugDumper"),
    ("libviso_tpu.utils.debug_viz", "save_histogram"),
    ("libviso_tpu.utils.debug_viz", "save_epipolar"),
    # P1/P4/P3/P5/P7 parallel
    ("libviso_tpu.parallel", "run_sharded_odometry"),
    ("libviso_tpu.parallel", "run_sharded_odometry_multihost"),
    ("libviso_tpu.parallel", "run_pipelined_odometry"),
    ("libviso_tpu.parallel.pp_odometry", "StreamPipeline"),
    ("libviso_tpu.parallel", "tp_match_descriptors"),
    ("libviso_tpu.parallel", "sharded_bundle_adjust"),
    ("libviso_tpu.parallel.distributed", "initialize_from_env"),
    # aux subsystems
    ("libviso_tpu.solvers.bundle_adjust", "bundle_adjust"),
    ("libviso_tpu.pipeline.windowed", "run_windowed_ba"),
    ("libviso_tpu.utils.checkpoint", "CheckpointManager"),
    ("libviso_tpu.utils.metrics", "MetricsLogger"),
    ("libviso_tpu.utils.metrics", "ate_rmse"),
    ("libviso_tpu.utils.profiling", "time_jitted"),
    ("libviso_tpu.utils.profiling", "profile_frame_step"),
    # mono Sim(3) back-end (beyond-reference, r5)
    ("libviso_tpu.geometry.sim3", "sim3_vector_to_matrix"),
    ("libviso_tpu.geometry.procrustes", "ransac_similarity"),
    ("libviso_tpu.solvers.pose_graph_sim3", "optimize_sim3_graph"),
    ("libviso_tpu.pipeline.mono_loop", "run_mono_sim3_loop"),
]


@pytest.mark.parametrize("module,symbol", SURFACE,
                         ids=[f"{m}.{s}" for m, s in SURFACE])
def test_symbol_exists(module, symbol):
    mod = importlib.import_module(module)
    assert hasattr(mod, symbol), f"{module}.{symbol} missing"


def test_loop_closure_surface():
    from libviso_tpu.pipeline.loop import run_with_loop_closure  # noqa
    from libviso_tpu.solvers.pose_graph import optimize_pose_graph  # noqa
