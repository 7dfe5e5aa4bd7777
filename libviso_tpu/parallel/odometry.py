"""Sequence-sharded stereo odometry (SURVEY.md P1, P2).

The reference processes frames strictly serially on one core
(src/viso.cpp:1205).  The only true sequential dependency is the shared
previous-frame features — a 1-frame halo.  So the design:

  1. split the sequence into overlapping chunks (overlap = 1 frame),
  2. shard chunks across the ``data`` mesh axis,
  3. run the jit-compiled per-frame step as a ``lax.scan`` inside each
     chunk (vmapped over the chunk axis),
  4. compose per-frame motions into global poses with one associative scan
     across the flattened timeline — O(log T) collective depth (NCCL over
     NVLink between GPUs).

Everything from detection to the pose chain is a single jit graph; XLA
partitions it over the mesh.
"""

from __future__ import annotations

from typing import Optional

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libviso_tpu.config import Calib, PipelineConfig
from libviso_tpu.geometry.se3 import chain_motions, pose_vector_to_matrix


def _pad_chunk(frames, lo, L):
    """Slice ``frames[lo: lo+L]`` padded to exactly L by repeating the last
    available frame (empty slices — a chunk starting at/past the final
    frame — repeat the final frame itself; such chunks carry n_valid=0 and
    their motions are masked out when stitching)."""
    frames = np.asarray(frames)
    lo = min(max(lo, 0), max(frames.shape[0] - 1, 0))
    chunk = frames[lo: lo + L]
    pad = L - chunk.shape[0]
    if pad > 0:
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
    return chunk


def _build_stitch_program(chunk_fn):
    """jit program shared by the single- and multi-controller drivers."""

    def program(ims1, ims2, n_valid, key):
        keys = jax.random.split(key, ims1.shape[0])
        trs, oks = jax.vmap(chunk_fn)(ims1, ims2, keys)
        return stitch_chunk_motions(trs, oks, n_valid)

    return program


def chunk_frames_with_halo(frames_left, frames_right, n_chunks):
    """Split (T, H, W) image stacks into overlapping chunks.

    Chunk b covers global frames [b*(L-1), b*(L-1) + L - 1] where
    L = ceil((T - 1) / n_chunks) + 1: consecutive chunks share one frame so
    every global frame transition is interior to exactly one chunk.  The
    tail is padded by repeating the last frame (padded transitions produce
    identity motions that are masked out when stitching).

    Returns (left (B, L, H, W), right (B, L, H, W), n_valid_motions (B,)).
    """
    frames_left = np.asarray(frames_left)
    frames_right = np.asarray(frames_right)
    T = frames_left.shape[0]
    steps = T - 1  # number of motions
    per = -(-steps // n_chunks)  # ceil
    L = per + 1
    lefts, rights, nvalid = [], [], []
    for b in range(n_chunks):
        s = b * per
        lefts.append(_pad_chunk(frames_left, s, L))
        rights.append(_pad_chunk(frames_right, s, L))
        nvalid.append(max(0, min(steps - s, per)))
    return (np.stack(lefts), np.stack(rights),
            np.asarray(nvalid, np.int32))


def build_chunk_odometry(calib: Calib, F, cfg: PipelineConfig):
    """Per-chunk odometry over a chunk's frames (frame-batched).

    Returns chunk_fn(ims1 (L,H,W), ims2 (L,H,W), key) ->
    (motions (L, 6), ok (L,)) where index t holds the motion from frame
    t-1 to t (index 0 is invalid — the chunk's halo frame).

    Uses the frame-batched pipeline (pipeline/batched.py): all detection,
    matching and RANSAC work inside a chunk runs as one vmapped graph —
    the serial scan would leave the chip idle between tiny per-frame ops.
    """
    from libviso_tpu.pipeline.batched import build_batched_odometry

    batched = build_batched_odometry(calib, F, cfg)

    def chunk_fn(ims1, ims2, key):
        out = batched(ims1, ims2, key)
        return out.motions, out.ok

    return chunk_fn


def stitch_chunk_motions(trs, oks, n_valid):
    """Flatten chunked motions into a global pose trajectory.

    Args:
      trs: (B, L, 6) per-chunk motions (slot 0 = halo, ignored).
      oks: (B, L) solver success flags.
      n_valid: (B,) real (non-padding) motion count per chunk.

    Returns (T, 4, 4) poses for the T = 1 + sum(n_valid) global frames,
    composed with one associative scan.
    """
    B, L = trs.shape[:2]
    local = jnp.arange(1, L)
    motions = trs[:, 1:].reshape(B * (L - 1), 6)
    valid = (oks[:, 1:] & (local[None, :] <= n_valid[:, None])).reshape(-1)
    pad_mask = (local[None, :] <= n_valid[:, None]).reshape(-1)
    Ts = pose_vector_to_matrix(motions)
    poses_all = chain_motions(Ts, valid)
    # keep identity pose for frame 0 + the real (non-padding) frames
    eye = jnp.eye(4, dtype=poses_all.dtype)[None]
    poses_full = jnp.concatenate([eye, poses_all], axis=0)
    keep = jnp.concatenate([jnp.ones((1,), bool), pad_mask])
    return poses_full, keep


def run_sharded_odometry(mesh: Mesh, P1, P2, frames_left, frames_right,
                         cfg: PipelineConfig = PipelineConfig(),
                         seed: int = 0):
    """Full sharded odometry: chunk, shard over 'data', solve, stitch.

    One jit-compiled program: per-chunk scans run data-parallel across the
    mesh; the final pose chain is an associative scan whose cross-chunk
    products XLA lowers to collectives.

    Args:
      mesh: mesh with a 'data' axis.
      P1, P2: 3x4 projections.
      frames_left/right: (T, H, W) full sequence image stacks (host).

    Returns (poses (T, 4, 4) np.ndarray, per-frame validity mask).
    """
    from libviso_tpu.geometry.mvg import F_from_P_host

    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    n_chunks = mesh.shape["data"]
    ims1, ims2, n_valid = chunk_frames_with_halo(frames_left, frames_right,
                                                 n_chunks)
    chunk_fn = build_chunk_odometry(calib, F, cfg)

    data_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())

    program = jax.jit(_build_stitch_program(chunk_fn))

    # dtype passthrough: uint8 frames ship at 1/4 the f32 traffic and the
    # detector casts on-device
    ims1 = jax.device_put(jnp.asarray(ims1), data_sharding)
    ims2 = jax.device_put(jnp.asarray(ims2), data_sharding)
    n_valid = jax.device_put(jnp.asarray(n_valid), data_sharding)
    key = jax.device_put(jax.random.PRNGKey(seed), replicated)

    poses_full, keep = program(ims1, ims2, n_valid, key)
    poses_full = np.asarray(poses_full)
    keep = np.asarray(keep)
    return poses_full[keep], keep


def host_chunk_assignment(total_frames: int, n_chunks: int,
                          process_index: int, process_count: int):
    """Chunk-aligned per-process frame plan for multi-controller runs.

    The global sequence splits into ``n_chunks`` chunks of ``L`` frames
    (L-1 motions each, 1-frame halo overlap, exactly as
    chunk_frames_with_halo).  Process p owns a contiguous block of
    ``n_chunks / process_count`` chunks and must load only the frame span
    covering them.

    Returns dict with:
      frame_start / frame_stop: [start, stop) global frames to load,
      chunk_starts: per-owned-chunk start frame (global),
      L: frames per chunk, n_valid: per-owned-chunk valid motion counts.
    """
    if n_chunks % process_count != 0:
        raise ValueError(f"n_chunks={n_chunks} not divisible by "
                         f"process_count={process_count}")
    steps = total_frames - 1
    per = -(-steps // n_chunks)  # ceil
    L = per + 1
    cpp = n_chunks // process_count
    first = process_index * cpp
    chunk_starts = [(first + b) * per for b in range(cpp)]
    frame_start = min(chunk_starts[0], max(total_frames - 1, 0))
    frame_stop = min(chunk_starts[-1] + L, total_frames)
    n_valid = [max(0, min(steps - s, per)) for s in chunk_starts]
    return {
        "frame_start": frame_start,
        "frame_stop": frame_stop,
        "chunk_starts": chunk_starts,
        "L": L,
        "n_valid": np.asarray(n_valid, np.int32),
    }


def run_sharded_odometry_multihost(mesh: Mesh, P1, P2, local_left,
                                   local_right, total_frames: int,
                                   cfg: PipelineConfig = PipelineConfig(),
                                   seed: int = 0):
    """Multi-controller sharded odometry (SURVEY.md P1 + P7).

    Every process calls this with only ITS frame span (the one
    ``host_chunk_assignment`` assigned — typically decoded from disk by
    that host alone); the global ('data'-sharded) chunk tensor is
    assembled with jax.make_array_from_process_local_data and the same
    jit program as the single-controller path runs across all hosts, XLA
    lowering the cross-chunk pose stitching to collectives.

    Args:
      local_left/right: (frame_stop - frame_start, H, W) this host's span.
      total_frames: GLOBAL sequence length (identical on every process).

    Returns (poses (T, 4, 4), keep mask) — replicated, identical on every
    process.
    """
    from libviso_tpu.geometry.mvg import F_from_P_host

    n_chunks = mesh.shape["data"]
    plan = host_chunk_assignment(total_frames, n_chunks,
                                 jax.process_index(), jax.process_count())
    L = plan["L"]
    local_left = np.asarray(local_left)
    local_right = np.asarray(local_right)
    expect = plan["frame_stop"] - plan["frame_start"]
    if local_left.shape[0] != expect:
        raise ValueError(
            f"process {jax.process_index()} must pass frames "
            f"[{plan['frame_start']}, {plan['frame_stop']}) = {expect} "
            f"frames, got {local_left.shape[0]}")

    lefts, rights = [], []
    for s in plan["chunk_starts"]:
        lo = s - plan["frame_start"]
        lefts.append(_pad_chunk(local_left, lo, L))
        rights.append(_pad_chunk(local_right, lo, L))
    # dtype passthrough (uint8 stays uint8; the detector casts on-device)
    local_chunks_l = np.stack(lefts)
    local_chunks_r = np.stack(rights)

    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    chunk_fn = build_chunk_odometry(calib, F, cfg)

    data_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())

    ims1 = jax.make_array_from_process_local_data(data_sharding,
                                                  local_chunks_l)
    ims2 = jax.make_array_from_process_local_data(data_sharding,
                                                  local_chunks_r)
    n_valid = jax.make_array_from_process_local_data(data_sharding,
                                                     plan["n_valid"])
    key = jax.device_put(jax.random.PRNGKey(seed), replicated)

    program = jax.jit(_build_stitch_program(chunk_fn),
                      out_shardings=(replicated, replicated))

    poses_full, keep = program(ims1, ims2, n_valid, key)
    poses_full = np.asarray(poses_full)
    keep = np.asarray(keep)
    return poses_full[keep], keep
