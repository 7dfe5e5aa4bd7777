"""Profiling / roofline reporting (SURVEY.md §5.1)."""

import numpy as np

from libviso_tpu.utils import profiling


def test_cost_models_scale_linearly():
    f1, b1 = profiling.match_cost_model(100, 200, 64)
    f2, b2 = profiling.match_cost_model(200, 200, 64)
    assert f2 == 2 * f1
    assert f1 == 3.0 * 100 * 200 * 64
    assert b1 == 4 * (100 * 64 + 200 * 64 + 100 * 200)
    fl2, _ = profiling.match_cost_model(100, 200, 64, metric="l2")
    assert fl2 == 2.0 * 100 * 200 * 64

    g1, _ = profiling.gn_cost_model(8, 10, 100)
    g2, _ = profiling.gn_cost_model(16, 10, 100)
    assert g2 == 2 * g1


def test_device_peaks_unknown_on_cpu():
    # conftest pins the test mesh to CPU: no fabricated denominator
    pf, pb = profiling.device_peaks()
    assert pf is None and pb is None


def test_profile_matcher_runs():
    st = profiling.profile_matcher(n1=128, n2=128, d=64, reps=3)
    assert st.seconds > 0
    assert st.gflops > 0
    assert st.flop_util is None  # CPU
    assert "match_dist" in st.pretty()


def test_profile_solver_runs():
    st = profiling.profile_solver(num_hypotheses=4, gn_iters=5,
                                  n_points=64, reps=3)
    assert st.seconds > 0 and np.isfinite(st.gflops)
    d = st.as_dict()
    assert set(d) >= {"name", "seconds", "flops", "gflops"}


def test_trace_writes_dir(tmp_path):
    import jax
    import jax.numpy as jnp

    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    import os

    assert os.path.isdir(logdir) and os.listdir(logdir)


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_device_peaks_h100():
    dev = _FakeDevice("gpu", "NVIDIA H100 80GB HBM3")
    assert profiling.device_peaks(dev) == (67e12, 3.35e12)
    lower = _FakeDevice("gpu", "nvidia h100 80gb hbm3")
    assert profiling.device_peaks(lower) == (67e12, 3.35e12)


def test_device_peaks_unknown_accelerator_is_an_error():
    import pytest

    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks(_FakeDevice("gpu", "Some Future GPU"))
