"""Test harness: run on a virtual 8-device CPU mesh.

Multi-device sharding tests follow SURVEY.md §4's implication: the reference
needed no distributed tests; we exercise ours on CPU via
``xla_force_host_platform_device_count`` exactly as the driver's multichip
dry-run does.
"""

import os

# Force CPU: the suite targets the virtual 8-device CPU mesh, whatever
# JAX_PLATFORMS the session has.  GPU runs go through chip_smoke.py and the
# tests marked `gpu`.  The live jax config is updated as well as the env
# var, in case jax was imported before this conftest (safe: no backend has
# been initialized yet when pytest collects it).
# `VISO_TEST_GPU=1 python -m pytest -m gpu tests/` runs the tests marked
# `gpu` on a card instead; they skip on a CPU-only run.
_GPU_RUN = os.environ.get("VISO_TEST_GPU") == "1"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _GPU_RUN else "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
if not _GPU_RUN:
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the virtual CPU mesh, got " + str(jax.devices()))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test on a host without one (decided here,
    at run time, so every xdist worker collects the same tests)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (VISO_TEST_GPU=1 on a card)")
    return gpus[0]
