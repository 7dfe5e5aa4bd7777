"""Profiling + roofline reporting (SURVEY.md §5.1).

The reference's only instrumentation is clock() deltas around the matcher
and frame loop (src/viso.cpp:674,725,1203,1328).  This module pairs

  * analytic FLOP/byte models of the hot kernels (the match-cost matrix and
    the vmapped GN/RANSAC solver — the two compute sinks identified in
    SURVEY.md §3.4/§3.5), with
  * a steady-state timing harness and a per-device peak table,

to report achieved GFLOP/s, GB/s, and fraction-of-peak per kernel, plus a
`trace()` context manager around jax.profiler for full XLA timelines.

The peak table holds published numbers with their source.  An accelerator
missing from it is an error, not a silent default; a CPU device reports
achieved rates only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Tuple

import jax
import numpy as np

# Published peaks of one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
# data sheet: dense rates without sparsity, at the 700 W power limit),
# keyed by a substring of jax's device_kind ("NVIDIA H100 80GB HBM3").
# The FLOP rate is true float32 on the CUDA cores, the precision of the
# HIGHEST products the profiled kernels run (the l2 matcher, the one-hot
# gathers, the GN normal equations).  TF32 on the tensor cores, what a
# float32 product at Precision DEFAULT gets, peaks at 495e12.  A card set
# below 700 W (nvidia-smi power.limit) cannot hold these.
_PEAKS = {
    "H100 80GB HBM3": (67e12, 3.35e12),  # (float32 FLOP/s, HBM bytes/s)
}


def device_peaks(device=None) -> Tuple[Optional[float], Optional[float]]:
    """(peak float32 FLOP/s, peak HBM bytes/s) of ``device``.

    ``(None, None)`` on a CPU device; ``ValueError`` for an accelerator
    whose kind is not in the table.
    """
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None, None
    kind = getattr(device, "device_kind", "")
    for sub, peaks in _PEAKS.items():
        if sub.lower() in kind.lower():
            return peaks
    raise ValueError(
        f"no published peaks for device kind {kind!r}; add its row, with "
        "the source, to utils/profiling.py::_PEAKS")


@dataclasses.dataclass
class KernelStats:
    name: str
    seconds: float               # median steady-state wall time
    flops: float                 # analytic FLOP count per invocation
    bytes: float                 # analytic HBM traffic per invocation
    gflops: float                # achieved
    gbytes_per_s: float          # achieved
    flop_util: Optional[float]   # fraction of device peak (None if unknown)
    bw_util: Optional[float]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def pretty(self) -> str:
        util = ("  util={:.1%}".format(self.flop_util)
                if self.flop_util is not None else "")
        bw = ("  bw={:.1%}".format(self.bw_util)
              if self.bw_util is not None else "")
        return (f"{self.name}: {self.seconds * 1e3:.3f} ms  "
                f"{self.gflops:.1f} GFLOP/s  "
                f"{self.gbytes_per_s:.1f} GB/s{util}{bw}")



def _per_iteration(st: KernelStats, chain: int) -> KernelStats:
    """Scale a chained measurement to per-iteration units CONSISTENTLY:
    seconds, flops, and bytes all divide by the chain length (scaling
    only seconds would make flops/seconds disagree with gflops)."""
    return dataclasses.replace(st, seconds=st.seconds / chain,
                               flops=st.flops / chain,
                               bytes=st.bytes / chain)

def time_jitted(fn: Callable, args: tuple = (), reps: int = 20,
                warmup: int = 3,
                make_args: Optional[Callable[[int], tuple]] = None) -> float:
    """Median steady-state seconds for one call of a jitted fn.

    ``make_args(i) -> args`` optionally varies the inputs per repetition
    (return pre-staged device arrays indexed by ``i``); otherwise every
    call gets ``args``.
    """
    if make_args is None:
        make_args = lambda i: args
    out = None
    for i in range(warmup):
        out = fn(*make_args(1_000_000 + i))
    if out is not None:
        jax.block_until_ready(out)
    times = []
    for i in range(reps):
        a = make_args(i)
        t0 = time.perf_counter()
        out = fn(*a)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_kernel(name: str, fn: Callable, args: tuple, flops: float,
                   nbytes: float, reps: int = 20,
                   make_args: Optional[Callable[[int], tuple]] = None
                   ) -> KernelStats:
    sec = time_jitted(fn, args, reps=reps, make_args=make_args)
    peak_f, peak_b = device_peaks()
    return KernelStats(
        name=name, seconds=sec, flops=flops, bytes=nbytes,
        gflops=flops / sec / 1e9,
        gbytes_per_s=nbytes / sec / 1e9,
        flop_util=(flops / sec / peak_f) if peak_f else None,
        bw_util=(nbytes / sec / peak_b) if peak_b else None,
    )


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace around a block; view with tensorboard/xprof."""
    with jax.profiler.trace(logdir):
        yield


# ---------------------------------------------------------------------------
# Analytic cost models for the hot kernels (SURVEY.md §6 workload constants).
# ---------------------------------------------------------------------------

def match_cost_model(n1: int, n2: int, d: int, metric: str = "l1",
                     dtype_bytes: int = 4) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) for one dense descriptor-distance matrix.

    l1: |a-b| summed over d -> 3 ops (sub, abs, add) per (i, j, k).
    l2: expanded to a matmul (-2ab term) + norm terms -> 2 n1 n2 d ops.
    Bytes: descriptors in + distance matrix out (the position/epipolar
    masks and 2-argmin fuse into the same pass).
    """
    if metric == "l1":
        flops = 3.0 * n1 * n2 * d
    else:
        flops = 2.0 * n1 * n2 * d
    nbytes = dtype_bytes * (n1 * d + n2 * d + n1 * n2)
    return flops, nbytes


def gn_cost_model(num_hypotheses: int, gn_iters: int, n_points: int
                  ) -> Tuple[float, float]:
    """(FLOPs, bytes) for the vmapped RANSAC+GN solve.

    Per point per iteration: 4x6 Jacobian build (~90 ops incl. the rotation
    chain), JtJ accumulation (4*36 mul-add = 288), Jtr (4*6*2 = 48),
    residual/prediction (~40); 6x6 Cholesky solve is O(100) per hypothesis.
    """
    per_point = 90 + 288 + 48 + 40
    flops = float(num_hypotheses) * gn_iters * (n_points * per_point + 150)
    nbytes = 4.0 * num_hypotheses * n_points * (3 + 4 + 4)  # X, obs, pred
    return flops, nbytes


def profile_matcher(n1: int = 1280, n2: int = 1280, d: int = 128,
                    metric: str = "l1",
                    reps: int = 20, seed: int = 0,
                    chain: int | None = None) -> KernelStats:
    """Time the descriptor-distance kernel at KITTI-scale shapes.

    `chain` iterations run inside ONE jit via lax.scan (each feeding a
    scalar of its output back into the next input, so XLA can't dedupe or
    elide them) — per-dispatch overhead amortizes away and the
    per-iteration time approaches the kernel's own.  The chain must make
    ``chain x per-iteration`` much longer than one dispatch.
    """
    if chain is None:
        chain = 256 if metric == "l1" else 4096
    import jax.numpy as jnp
    from jax import lax

    from libviso_tpu.ops.matching import descriptor_distances

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n1, d)).astype(np.float32)
    # pre-staged distinct query buffers per rep
    d1s = [jnp.asarray(base * (1.0 + 0.001 * k)) for k in range(reps + 4)]
    d2 = jnp.asarray(rng.standard_normal((n2, d)), jnp.float32)

    def fn(a, b):
        def body(carry, _):
            dist = descriptor_distances(a + carry, b, metric=metric)
            # full-output sum: DCE-proof (a sliced consumer lets XLA
            # compute a single row) and non-simplifiable (|.| / sqrt
            # block algebraic loop hoisting)
            return jnp.sum(dist) * 1e-20, None
        return lax.scan(body, jnp.float32(0), None, length=chain)[0]

    fn = jax.jit(fn)
    flops, nbytes = match_cost_model(n1, n2, d, metric=metric)
    st = profile_kernel(f"match_dist[{metric}] "
                        f"{n1}x{n2}x{d}", fn, (),
                        flops * chain, nbytes * chain, reps=reps,
                        make_args=lambda i: (d1s[i % len(d1s)], d2))
    st = _per_iteration(st, chain)
    return st


def profile_solver(num_hypotheses: int = 64, gn_iters: int = 20,
                   n_points: int = 1280, reps: int = 20,
                   seed: int = 0, chain: int = 64) -> KernelStats:
    """Time the vmapped RANSAC+GN pose solver at KITTI-scale shapes.

    Chained like profile_matcher so per-dispatch latency amortizes.
    """
    import jax.numpy as jnp
    from jax import lax

    from libviso_tpu.config import Calib, RansacConfig
    from libviso_tpu.solvers.ransac import ransac_pose
    from libviso_tpu.synthetic import kitti_projections

    P1, P2 = kitti_projections()
    calib = Calib.from_projections(P1, P2)
    cfg = RansacConfig(num_hypotheses=num_hypotheses, gn_iters=gn_iters)
    rng = np.random.default_rng(seed)
    Xb = rng.uniform(-10, 10, (n_points, 3)).astype(np.float32)
    obs = jnp.asarray(rng.uniform(0, 300, (n_points, 4)), jnp.float32)
    valid = jnp.ones((n_points,), bool)
    key = jax.random.PRNGKey(seed)
    # distinct pre-staged buffers per rep
    Xs = [jnp.asarray(Xb * (1.0 + 0.001 * k)) for k in range(reps + 4)]

    def fn(x, o):
        def body(carry, i):
            est = ransac_pose(jax.random.fold_in(key, i), x + carry, o,
                              valid, calib, cfg)
            return jnp.sum(est.tr) * 1e-20, None
        return lax.scan(body, jnp.float32(0), jnp.arange(chain))[0]

    fn = jax.jit(fn)
    flops, nbytes = gn_cost_model(num_hypotheses, gn_iters, n_points)
    st = profile_kernel(
        f"ransac_gn K={num_hypotheses} iters={gn_iters} N={n_points}",
        fn, (), flops * chain, nbytes * chain, reps=reps,
        make_args=lambda i: (Xs[i % len(Xs)], obs))
    st = _per_iteration(st, chain)
    return st


def profile_frame_step(cfg=None, reps: int = 5, chain: int = 128,
                       seed: int = 0) -> KernelStats:
    """Chained timing of the FULL stereo frame step (detect through RANSAC).

    The one number that bounds streaming throughput on a production host;
    state threads through the chain so every iteration is a real step.
    """
    import jax.numpy as jnp
    from jax import lax

    from libviso_tpu.config import Calib, PipelineConfig
    from libviso_tpu.geometry.mvg import F_from_P_host
    from libviso_tpu.pipeline.stereo import build_frame_step, empty_state
    from libviso_tpu.synthetic import generate_sequence

    cfg = cfg or PipelineConfig()
    seq = generate_sequence(num_frames=8, num_points=900, seed=seed,
                            width=1241, height=376, f=718.856,
                            base=0.5371657, speed=0.8)
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = jnp.asarray(F_from_P_host(seq.P1, seq.P2))
    frames_np = np.stack(
        [np.stack([f[0], f[1]]) for f in seq.frames]).astype(np.float32)
    # distinct pre-staged frame stacks per rep; intensity scaling
    # preserves the corner set so every chained step does representative
    # work
    stacks = [jnp.asarray(frames_np * (1.0 + 0.002 * k))
              for k in range(reps + 4)]
    key = jax.random.PRNGKey(seed)
    step = build_frame_step(calib, F, cfg)

    def fn(frames):
        st0 = empty_state(cfg)

        def body(carry, i):
            st, c = carry
            f = frames[i % frames.shape[0]]
            st, out = step(st, f[0] * (1.0 + c), f[1] * (1.0 + c),
                           jax.random.fold_in(key, i))
            return (st, jnp.sum(out.tr) * 1e-9), None

        (_, c), _ = jax.lax.scan(body, (st0, jnp.float32(0)),
                                 jnp.arange(chain))
        return c

    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    mf, mb = match_cost_model(n, n, d)
    gf, gb = gn_cost_model(cfg.ransac.num_hypotheses,
                           cfg.ransac.fit_gn_iters, n)
    st = profile_kernel(
        "frame_step", jax.jit(fn), (), (3 * mf + gf) * chain,
        (3 * mb + gb) * chain, reps=reps,
        make_args=lambda i: (stacks[i % len(stacks)],))
    st = _per_iteration(st, chain)
    return st


def profile_mono_step(cfg=None, method: str = "5pt", reps: int = 5,
                      chain: int = 16, seed: int = 0) -> KernelStats:
    """Chained timing of the FULL monocular frame step (detect through
    essential-matrix RANSAC + pose recovery), dispatch-amortized like
    profile_frame_step."""
    import jax.numpy as jnp

    from libviso_tpu.config import PipelineConfig
    from libviso_tpu.pipeline.mono import build_mono_step, empty_mono_state
    from libviso_tpu.synthetic import generate_sequence

    cfg = cfg or PipelineConfig.mono()
    seq = generate_sequence(num_frames=8, num_points=900, seed=seed,
                            width=1241, height=376, f=718.856,
                            base=0.5371657, speed=0.8)
    K = np.array([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22],
                  [0.0, 0.0, 1.0]])
    frames_np = np.stack([f[0] for f in seq.frames]).astype(np.float32)
    # distinct pre-staged stacks per rep (see profile_matcher)
    stacks = [jnp.asarray(frames_np * (1.0 + 0.002 * k))
              for k in range(reps + 4)]
    key = jax.random.PRNGKey(seed)
    step = build_mono_step(K, cfg, method=method)

    def fn(frames):
        st0 = empty_mono_state(cfg)

        def body(carry, i):
            st, c = carry
            f = frames[i % frames.shape[0]]
            st, out = step(st, f * (1.0 + c), jax.random.fold_in(key, i))
            return (st, jnp.sum(jnp.abs(out.transform)) * 1e-9), None

        (_, c), _ = jax.lax.scan(body, (st0, jnp.float32(0)),
                                 jnp.arange(chain))
        return c

    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    mf, mb = match_cost_model(n, n, d)
    st = profile_kernel(
        f"mono_step[{method}]", jax.jit(fn), (), mf * chain, mb * chain,
        reps=reps, make_args=lambda i: (stacks[i % len(stacks)],))
    st = _per_iteration(st, chain)
    return st
