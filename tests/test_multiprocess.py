"""REAL multi-process jax.distributed validation (SURVEY.md P7).

Launches two actual Python processes that rendezvous through
``initialize_from_env`` (VISO_* env contract), build a global 4-device
mesh (2 procs x 2 virtual CPU devices), assemble a globally-sharded array
from process-local chunks, and reduce across processes — the full
multi-controller path minus the accelerators.  Skips rather than fails if
the sandbox blocks localhost gRPC.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow

_WORKER = textwrap.dedent("""
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from libviso_tpu.parallel import make_mesh
    from libviso_tpu.parallel.distributed import (
        describe, global_frame_array, host_frame_range,
        initialize_from_env)

    assert initialize_from_env(), "multi-process init expected"
    info = describe()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 4, info

    # per-host frame placement arithmetic agrees across processes
    start, stop = host_frame_range(9, info["process_count"],
                                   jax.process_index())

    mesh = make_mesh(n_data=4, n_model=1)
    local = np.full((2, 4), jax.process_index() + 1.0, np.float32)
    arr = global_frame_array(mesh, local)
    total = jax.jit(lambda a: a.sum(),
                    out_shardings=NamedSharding(mesh, P()))(arr)
    # proc0 contributes 8x1, proc1 8x2 -> 24 on BOTH controllers
    assert float(total) == 24.0, float(total)

    # --- REAL distributed stereo odometry: each process feeds only its
    # chunk-aligned frame span; poses come back replicated ---
    from libviso_tpu.config import (DetectorConfig, PipelineConfig,
                                    RansacConfig)
    from libviso_tpu.parallel import (host_chunk_assignment,
                                      run_sharded_odometry_multihost)
    from libviso_tpu.synthetic import generate_sequence
    from libviso_tpu.utils.metrics import ate_rmse

    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=120, nbinx=6, nbiny=2,
                                num_slots=128),
        ransac=RansacConfig(num_hypotheses=8, gn_iters=10))
    seq = generate_sequence(num_frames=9, num_points=150, width=128,
                            height=64, f=100.0, seed=0)
    T = len(seq.frames)
    plan = host_chunk_assignment(T, 4, jax.process_index(), 2)
    lo, hi = plan["frame_start"], plan["frame_stop"]
    left = np.stack([f[0] for f in seq.frames[lo:hi]])
    right = np.stack([f[1] for f in seq.frames[lo:hi]])
    poses, keep = run_sharded_odometry_multihost(
        mesh, seq.P1, seq.P2, left, right, total_frames=T, cfg=cfg,
        seed=0)
    assert poses.shape == (T, 4, 4), poses.shape
    ate = ate_rmse(poses, seq.gt_poses)
    # toy shapes (128x64, 8 hypotheses): coarse accuracy; the assertion
    # is that the distributed pipeline produces a sane, consistent
    # trajectory on every controller
    assert ate < 1.5, ate
    print(f"OK proc={jax.process_index()} range=({start},{stop}) "
          f"ate={ate:.4f}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_collectives(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env_base = dict(
        os.environ,
        VISO_COORDINATOR=f"127.0.0.1:{_free_port()}",
        VISO_NUM_PROCESSES="2",
        PYTHONPATH=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    )
    # the workers set their own JAX_PLATFORMS/XLA_FLAGS
    for k in ("JAX_PLATFORMS", "XLA_FLAGS"):
        env_base.pop(k, None)

    procs = []
    for pid in range(2):
        env = dict(env_base, VISO_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("distributed rendezvous timed out in this sandbox")
        outs.append((p.returncode, out))

    if any(rc != 0 for rc, _ in outs):
        joined = "\n---\n".join(o for _, o in outs)
        if ("UNAVAILABLE" in joined or "DEADLINE_EXCEEDED" in joined
                or "Permission" in joined):
            pytest.skip(f"sandbox blocks localhost gRPC:\n{joined[-500:]}")
        raise AssertionError(joined)
    assert all("OK proc=" in o for _, o in outs)
    # frame ranges from the two processes cover all motions exactly once
    ranges = sorted(o.split("range=")[1].split()[0] for _, o in outs)
    assert ranges == ["(0,5)", "(4,9)"], ranges
