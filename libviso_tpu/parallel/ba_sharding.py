"""Sequence-parallel sharded bundle adjustment (SURVEY.md P5).

The BA window's heavy axis is landmarks: every normal-equation block
(U, V, W_kj, rhs) is a reduction or map over L.  This module runs
``bundle_adjust`` with the landmark axis sharded over the mesh's 'model'
axis via NamedSharding — XLA turns the L-reductions (U, S, b_p) into
psum/reduce-scatter across devices and leaves the per-landmark blocks (V, b_l,
back-substitution) fully local, which is exactly the Schur-complement
communication pattern hand-written in distributed BA systems
(SURVEY.md §5.7: Hessian-block psum/reduce_scatter).

No kernel changes are needed: the solver is already pure batched einsums
(solvers/bundle_adjust.py), so sharding is a placement decision.  Bit-level
equality with the unsharded solve is NOT guaranteed (reduction order
changes under psum); tests assert tight numerical agreement instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libviso_tpu.config import Calib
from libviso_tpu.solvers.bundle_adjust import BAResult, bundle_adjust


def sharded_bundle_adjust(mesh: Mesh, poses0, X0, obs, mask, calib: Calib,
                          iters: int = 10, damping: float = 1e-4,
                          fix_first: bool = True,
                          axis: str = "model") -> BAResult:
    """Run window BA with the landmark axis sharded over ``axis``.

    Args:
      mesh: device mesh containing ``axis``.
      poses0: (W, 6) initial poses (replicated).
      X0: (L, 3) landmarks — sharded along L.
      obs: (W, L, 4) observations — sharded along L.
      mask: (W, L) visibility — sharded along L.

    L must be divisible by the axis size.  Returns a BAResult whose
    landmark tensor keeps the same sharding; poses are replicated.
    """
    L = X0.shape[0]
    k = mesh.shape[axis]
    if L % k != 0:
        raise ValueError(f"L={L} not divisible by mesh axis "
                         f"{axis!r} size {k}")

    rep = NamedSharding(mesh, P())
    shard_l0 = NamedSharding(mesh, P(axis))        # (L, ...) leading axis
    shard_l1 = NamedSharding(mesh, P(None, axis))  # (W, L, ...) second axis

    fn = jax.jit(
        partial(bundle_adjust, calib=calib, iters=iters, damping=damping,
                fix_first=fix_first),
        in_shardings=(rep, shard_l0, shard_l1, shard_l1),
        out_shardings=BAResult(
            poses=rep, landmarks=shard_l0, cost=rep, initial_cost=rep,
            iters=rep),
    )
    return fn(jnp.asarray(poses0), jnp.asarray(X0), jnp.asarray(obs),
              jnp.asarray(mask))
