"""Multi-host init + per-host frame placement (SURVEY.md P7).

Real multi-process init needs multiple controllers; what IS unit-testable:
the env-var no-op contract, the host chunk/halo arithmetic (every motion
covered exactly once, halos correct at boundaries), and global array
assembly on the single-process 8-device mesh.
"""

import numpy as np
import pytest

from libviso_tpu.parallel import make_mesh
from libviso_tpu.parallel.distributed import (
    describe,
    global_frame_array,
    host_frame_range,
    initialize_from_env,
)


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("VISO_NUM_PROCESSES", raising=False)
    assert initialize_from_env() is False
    monkeypatch.setenv("VISO_NUM_PROCESSES", "1")
    assert initialize_from_env() is False


@pytest.mark.parametrize("num_frames,num_hosts", [
    (11, 2), (12, 3), (100, 7), (5, 4), (2, 1),
])
def test_host_ranges_cover_all_motions(num_frames, num_hosts):
    """Union of owned motions == {1..T-1}, each exactly once; halo loads
    the predecessor frame of each chunk's first motion."""
    owned = []
    for h in range(num_hosts):
        start, stop = host_frame_range(num_frames, num_hosts, h, halo=1)
        assert 0 <= start < stop <= num_frames
        # motions owned by h: every frame in [start+1, stop) pairs with
        # its predecessor which is also loaded (halo)
        owned.extend(range(start + 1, stop))
    assert sorted(owned) == list(range(1, num_frames))


def test_host_range_halo_zero():
    s0, e0 = host_frame_range(10, 3, 0, halo=0)
    s1, e1 = host_frame_range(10, 3, 1, halo=0)
    # without the halo the first motion's predecessor frame is NOT loaded
    assert s1 == e0
    s1h, _ = host_frame_range(10, 3, 1, halo=1)
    assert s1h == s1 - 1


def test_host_range_validates():
    with pytest.raises(ValueError):
        host_frame_range(10, 2, 5)


def test_balanced_within_one():
    sizes = []
    for h in range(5):
        s, e = host_frame_range(103, 5, h, halo=0)
        sizes.append(e - s)
    assert max(sizes) - min(sizes) <= 1


def test_global_frame_array_single_process(rng):
    mesh = make_mesh(n_data=8, n_model=1)
    frames = rng.standard_normal((8, 4, 6)).astype(np.float32)
    arr = global_frame_array(mesh, frames)
    assert arr.shape == (8, 4, 6)
    np.testing.assert_array_equal(np.asarray(arr), frames)
    # actually sharded over 'data'
    assert len(arr.sharding.device_set) == 8


def test_describe_keys():
    d = describe()
    assert d["process_count"] == 1
    assert d["local_devices"] == 8


def test_initialize_from_env_pins_one_local_device(monkeypatch):
    """Several processes on one host: each opens only its own card."""
    import jax

    from libviso_tpu.parallel import distributed

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False,
                        raising=False)
    monkeypatch.setenv("VISO_NUM_PROCESSES", "4")
    monkeypatch.setenv("VISO_COORDINATOR", "localhost:9876")
    for pid in range(4):
        monkeypatch.setenv("VISO_PROCESS_ID", str(pid))
        monkeypatch.setenv("VISO_LOCAL_DEVICE", str(pid))
        assert distributed.initialize_from_env()
    assert [c["local_device_ids"] for c in calls] == [[0], [1], [2], [3]]
    assert [c["process_id"] for c in calls] == [0, 1, 2, 3]
    monkeypatch.delenv("VISO_LOCAL_DEVICE")
    distributed.initialize_from_env()
    assert calls[-1]["local_device_ids"] is None
