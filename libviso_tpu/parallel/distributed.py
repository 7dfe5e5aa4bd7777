"""Multi-host initialization + per-host data placement (SURVEY.md P7).

The reference is single-process (SURVEY.md §2.2); scale-out here follows
the JAX multi-controller model: every host runs the same program,
`jax.distributed.initialize` wires the coordination service, and the
sharded odometry program (parallel/odometry.py) runs under a GLOBAL mesh —
XLA lowers the cross-chunk pose stitching to collectives (NCCL over NVLink
between the GPUs of a host).  Collectives are compiled, not hand-rolled
(SURVEY.md §5.8).

Launch contract (each host):

    VISO_COORDINATOR=host0:9876 VISO_NUM_PROCESSES=4 VISO_PROCESS_ID=k \
        python -m libviso_tpu.cli kitti ...

plus `initialize_from_env()` early in main.  When several processes share
one host (one per GPU), give each its card as ``VISO_LOCAL_DEVICE=<index>``:
a process that opens every local GPU reserves memory on all of them and
the others then fail for want of it.  Two per-host data plans live here
and in parallel/odometry.py — use the one matching the program you run:

  - frame-level sharding: decode `host_frame_range()`'s span (remainder
    spread over the leading hosts, 1-frame halo) and assemble with
    `global_frame_array()`;
  - the CHUNKED odometry program (`run_sharded_odometry_multihost`):
    decode `parallel.odometry.host_chunk_assignment()`'s span — its
    chunk-aligned uniform-ceil partitioning differs from
    host_frame_range whenever motions % hosts != 0, and the program
    validates against it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ENV_COORD = "VISO_COORDINATOR"
_ENV_NPROC = "VISO_NUM_PROCESSES"
_ENV_PID = "VISO_PROCESS_ID"
_ENV_LOCAL = "VISO_LOCAL_DEVICE"


def initialize_from_env() -> bool:
    """Initialize jax.distributed from VISO_* env vars.

    Returns True if multi-process init ran, False for the single-process
    no-op (unset vars or VISO_NUM_PROCESSES=1).  Safe to call twice.
    ``VISO_LOCAL_DEVICE`` pins the process to that one local device
    (``local_device_ids``) when several processes share a host.
    """
    nproc = os.environ.get(_ENV_NPROC)
    if nproc is None or int(nproc) <= 1:
        return False
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return True
    local = os.environ.get(_ENV_LOCAL)
    jax.distributed.initialize(
        coordinator_address=os.environ.get(_ENV_COORD),
        num_processes=int(nproc),
        process_id=(int(os.environ[_ENV_PID])
                    if _ENV_PID in os.environ else None),
        local_device_ids=None if local is None else [int(local)],
    )
    return True


def host_frame_range(num_frames: int, num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None,
                     halo: int = 1) -> Tuple[int, int]:
    """[start, stop) frame range THIS host must load, halo included.

    The sequence splits into num_hosts chunks of per-frame *motions*
    (frames 1..T-1 pair with their predecessor), so chunk h owns motion
    frames [h*c+1, (h+1)*c+1) and must additionally decode `halo` earlier
    frames for the prev-frame dependency.  Chunk sizes differ by at most
    one frame (remainder spread over the leading hosts).
    """
    if num_hosts is None:
        num_hosts = jax.process_count()
    if host_id is None:
        host_id = jax.process_index()
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} out of range [0, {num_hosts})")
    motions = max(num_frames - 1, 0)
    base, rem = divmod(motions, num_hosts)
    start_motion = host_id * base + min(host_id, rem)
    stop_motion = start_motion + base + (1 if host_id < rem else 0)
    # motion m is frame pair (m, m+1); load [first - halo, last + 1)
    start = max(start_motion + 1 - halo, 0)
    stop = min(stop_motion + 1, num_frames)
    return start, stop


def global_frame_array(mesh: Mesh, local_frames: np.ndarray,
                       axis: str = "data"):
    """Assemble the globally-(axis-)sharded frame array from local chunks.

    Each process passes only its own frames (host_frame_range order);
    jax.make_array_from_process_local_data builds the global device array
    without gathering everything to one host.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_frames)


def describe() -> dict:
    """Process/topology facts for logs and metrics headers."""
    devs = jax.devices()
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(devs),
        "local_devices": len(jax.local_devices()),
        "platform": devs[0].platform if devs else None,
        "device_kind": devs[0].device_kind if devs else None,
    }
