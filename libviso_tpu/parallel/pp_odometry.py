"""Pipeline-parallel staged odometry (SURVEY.md P4).

The reference computes each frame's whole step on one core
(src/viso.cpp:1205-1321).  This module stages the per-frame step across
two devices:

  stage 0 (prepare): Harris detection + Sobel descriptors + all three
      match problems + circle filter + triangulation for frame t — owns
      the previous-frame FrameState locally
      (pipeline/stereo.py frontend + build_prepare)
  stage 1 (solve):   vmapped RANSAC+GN pose for frame t-1
      (pipeline/stereo.py build_solve)

The boundary is the SolveInput pytree (~21 KB/frame: gathered 3D points,
observations, validity) rather than raw features (~1.4 MB) — the cheap
seam.  Current stage costs (docs/scaling.md): prepare ~2.5 ms vs solve
~1.3 ms, so steady-state is ~max(stage) ≈ 2.5 ms vs the 4.0 ms serial
frame — ~1.6x with 2 chips (the matcher dominates prepare and cannot be
split across the seam).

Two drivers:

  * run_pipelined_odometry — offline: one jit graph, a lax.scan over T+1
    ticks inside shard_map over a ('pipe',) mesh axis; device 0 prepares
    frame k while device 1 solves frame k-1, ppermute carrying the
    SolveInput.  Each device picks its stage with lax.cond on axis_index
    (manual-mode SPMD with per-device control flow).

  * StreamPipeline — LIVE streams, where future frames do not exist yet
    and chunked DP (parallel/odometry.py) cannot apply: a host-driven
    loop with the prepare and solve jits dispatched asynchronously on two
    devices; frame t's prepare overlaps frame t-1's solve.

Both produce trajectories bit-identical to the serial streaming path
(pipeline/stereo.py::run_stereo_sequence): per-frame PRNG keys are the
same ``fold_in(key, t)``, the tick-0 bubble solves an all-invalid
SolveInput (ok=False, dropped), and the prepare stage threads the exact
serial FrameState.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libviso_tpu.config import Calib, PipelineConfig
from libviso_tpu.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_tpu.pipeline.stereo import (
    FrameOutput,
    build_frontend,
    build_prepare,
    build_solve,
    empty_state,
    zero_solve_input,
)

NUM_STAGES = 2


def _reject_keep_on_failure(cfg: PipelineConfig):
    if cfg.keep_features_on_failure:
        # prepare(k+1) runs before/concurrently-with solve(k) across the
        # stage seam, so the held-state decision (which needs solve(k)'s
        # ok) cannot exist here
        raise ValueError(
            "keep_features_on_failure is a streaming-step feature; the "
            "prepare|solve pipeline stages cannot condition frame k+1's "
            "match target on frame k's solve outcome")


def build_pipelined_program(calib: Calib, F, cfg: PipelineConfig,
                            mesh: Mesh):
    """Build fn(ims1 (T,H,W), ims2 (T,H,W), key) -> FrameOutput over T
    frames, jit-compiled over the mesh's 2-device ``pipe`` axis.

    Output row t is frame t's result (row 0 is the first frame — always
    not-ok, like the reference's `first` skip, src/viso.cpp:1256-1260).
    """
    if mesh.shape["pipe"] != NUM_STAGES:
        raise ValueError(
            f"pipe axis must have {NUM_STAGES} devices "
            f"(got {mesh.shape['pipe']}): the VO step splits into "
            "prepare and solve stages")
    _reject_keep_on_failure(cfg)

    frontend = build_frontend(cfg)
    solve = build_solve(calib, cfg)

    def program(ims1, ims2, key):
        from libviso_tpu.pipeline.stereo import build_prepare as _bp

        # built at trace time: the static frame width reaches the
        # strip-banded matcher (keeps PP bit-consistent with the
        # serial step, which bands the same way)
        prepare = _bp(calib, F, cfg,
                      image_width=ims1.shape[-1])
        T = ims1.shape[0]

        def body(ims1, ims2, key):
            stage = jax.lax.axis_index("pipe")

            def zero_out(dtype):
                z = jnp.zeros((), jnp.int32)
                return FrameOutput(
                    tr=jnp.zeros((6,), dtype), ok=jnp.zeros((), bool),
                    num_circle=z, num_inliers=z, num_lr=z, num_kp1=z,
                    rms=jnp.zeros((), dtype),
                    sharpness=jnp.zeros((), dtype))

            def stage0(si_in, state, k):
                # prepare frame k (clamped past the end: those ticks'
                # outputs never leave the bubble); the FrameState lives
                # here and never crosses the wire
                t = jnp.minimum(k, T - 1)
                feats = frontend(
                    jax.lax.dynamic_index_in_dim(ims1, t, keepdims=False),
                    jax.lax.dynamic_index_in_dim(ims2, t, keepdims=False))
                new_state, si, _ = prepare(feats, state)
                return si, new_state, zero_out(si.obs.dtype)

            def stage1(si_in, state, k):
                # solve frame k-1 from the SolveInput received last tick;
                # tick 0 solves the all-invalid bubble (ok=False, dropped)
                t = jnp.maximum(k - 1, 0)
                out = solve(si_in, jax.random.fold_in(key, t))
                return si_in, state, out

            def tick(carry, k):
                si_buf, state = carry
                si, state, out = jax.lax.cond(
                    stage == 0, stage0, stage1, si_buf, state, k)
                # hand stage 0's SolveInput to stage 1 for the next tick
                si_next = jax.lax.ppermute(si, "pipe", perm=[(0, 1)])
                return (si_next, state), out

            carry0 = (zero_solve_input(cfg), empty_state(cfg))
            _, outs = jax.lax.scan(tick, carry0,
                                   jnp.arange(T + 1, dtype=jnp.int32))
            # outs live on stage 1 (stage 0 rows are zeros) -> replicate
            # (bools ride the sum as int32)
            outs = jax.tree_util.tree_map(
                lambda x: jax.lax.psum(
                    x.astype(jnp.int32) if x.dtype == jnp.bool_ else x,
                    "pipe"), outs)
            return outs._replace(ok=outs.ok.astype(bool))

        # check_vma off: the stages' per-device control flow (cond on
        # axis_index, solver while_loops over device-varying data) is
        # exactly what the varying-mode analysis cannot type; the psum
        # above makes the outputs replicated by construction
        outs = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P()), out_specs=P(),
            check_vma=False,
        )(ims1, ims2, key)
        # tick k solved frame k-1: drop the tick-0 bubble row
        return jax.tree_util.tree_map(lambda x: x[1:], outs)

    return program


def run_pipelined_odometry(mesh: Mesh, P1, P2, frames_left, frames_right,
                           cfg: PipelineConfig = PipelineConfig(),
                           seed: int = 0):
    """Run staged-pipeline odometry over a ('pipe',) mesh of 2 devices.

    Args:
      mesh: mesh with a 'pipe' axis of size 2.
      P1, P2: 3x4 rectified projections.
      frames_left/right: (T, H, W) image stacks.

    Returns (poses (T, 4, 4), motions (T, 6), ok (T,)) as numpy arrays;
    bit-identical to `run_stereo_sequence` on the same inputs.
    """
    from libviso_tpu.geometry.mvg import F_from_P_host

    calib = Calib.from_projections(P1, P2)
    F = F_from_P_host(P1, P2)
    program = jax.jit(build_pipelined_program(calib, F, cfg, mesh))

    replicated = NamedSharding(mesh, P())
    ims1 = jax.device_put(jnp.asarray(np.asarray(frames_left)), replicated)
    ims2 = jax.device_put(jnp.asarray(np.asarray(frames_right)), replicated)
    key = jax.device_put(jax.random.PRNGKey(seed), replicated)

    outs = program(ims1, ims2, key)
    return _assemble(outs)


def _assemble(outs):
    motions = np.asarray(outs.tr)
    ok = np.array(outs.ok)
    if len(ok):
        ok[0] = False  # reference skips the first frame (viso.cpp:1256)
    Ts = pose_vector_to_matrix(jnp.asarray(motions))
    poses = np.asarray(chain_motions(Ts, jnp.asarray(ok)))
    return poses, motions, ok


import functools


@functools.lru_cache(maxsize=8)
def _stream_jits(calib: Calib, f_bytes: bytes, cfg: PipelineConfig):
    """One (prepare, solve) jit pair per configuration: constructing a
    second StreamPipeline with the same setup must not recompile the
    front-end."""
    F = np.frombuffer(f_bytes, np.float64).reshape(3, 3)
    frontend = build_frontend(cfg)

    def _prep(state, im1, im2):
        # prepare built at trace time: static width -> banded matcher,
        # bit-consistent with the serial step
        prepare = build_prepare(calib, F, cfg,
                                image_width=im1.shape[-1])
        return prepare(frontend(im1, im2), state)[:2]

    prep = jax.jit(_prep)
    solve = jax.jit(build_solve(calib, cfg))
    return prep, solve


class StreamPipeline:
    """Live-stream pipeline parallelism: two async jits on two devices.

    Frames are pushed one at a time (they need not exist in advance —
    the case chunked DP cannot serve).  Each ``push(im1, im2)``
    dispatches frame t's prepare on device 0 and frame t-1's solve on
    device 1; JAX's async dispatch runs them concurrently, so the
    steady-state latency per frame is ~max(stage) instead of their sum.
    Outputs come back with one frame of pipeline latency and are
    bit-identical to the serial path.

    Usage::

        sp = StreamPipeline(P1, P2, cfg, devices=jax.devices()[:2])
        for im1, im2 in camera:
            out = sp.push(im1, im2)    # FrameOutput of the PREVIOUS frame
            ...
        out_last = sp.flush()
    """

    def __init__(self, P1, P2, cfg: PipelineConfig = PipelineConfig(),
                 devices=None, seed: int = 0):
        from libviso_tpu.geometry.mvg import F_from_P_host

        if devices is None:
            devices = jax.devices()[:2]
        if len(devices) < 2:
            raise ValueError("StreamPipeline needs 2 devices")
        _reject_keep_on_failure(cfg)
        self.d_prep, self.d_solve = devices[0], devices[1]
        calib = Calib.from_projections(P1, P2)
        F = F_from_P_host(P1, P2)
        self._prep, self._solve = _stream_jits(
            calib, np.ascontiguousarray(F, np.float64).tobytes(), cfg)
        self._state = jax.device_put(empty_state(cfg), self.d_prep)
        self._key = jax.random.PRNGKey(seed)
        self._pending = None   # SolveInput of the last prepared frame
        self._t = 0

    def push(self, im1, im2):
        """Feed frame t; returns frame t-1's FrameOutput (None at t=0)."""
        out = None
        if self._pending is not None:
            # dispatch the solve FIRST so it overlaps this frame's prepare
            out = self._solve(self._pending,
                              jax.random.fold_in(self._key, self._t - 1))
        im1 = jax.device_put(jnp.asarray(im1), self.d_prep)
        im2 = jax.device_put(jnp.asarray(im2), self.d_prep)
        self._state, si = self._prep(self._state, im1, im2)
        # ship the ~21 KB SolveInput to the solve device (async copy)
        self._pending = jax.device_put(si, self.d_solve)
        self._t += 1
        return out

    def flush(self):
        """Solve the final in-flight frame (drains the pipeline)."""
        if self._pending is None:
            return None
        out = self._solve(self._pending,
                          jax.random.fold_in(self._key, self._t - 1))
        self._pending = None
        return out
