"""Sim(3) pose-graph optimization: the scale-drift-aware mono back-end.

The SE(3) graph (solvers/pose_graph.py) removes rotational and
translational drift but is structurally blind to monocular SCALE drift:
its 6-dof residual cannot express "this loop came back 12% smaller", so
a scale-inconsistent loop edge is either mis-absorbed as translation
error or rejected by the robust kernel.  This solver optimizes the same
graph over Sim(3) nodes (geometry/sim3.py): 7-dof residuals

    r_ij = vec7( inv(Z_ij) @ inv(S_i) @ S_j )

where odometry edges carry s = 1 (mono VO is locally scale-consistent —
drift accumulates over many steps) and loop edges carry the measured
relative scale (pipeline/mono_loop.py derives it from two-view loop
depths vs the propagated landmark depths on each side).

Structure mirrors ``optimize_pose_graph`` deliberately — per-node DELTA
parameterization around the initial poses (every delta stays near the
identity, so the Euler-XYZ + log-scale coordinates are well-conditioned
regardless of absolute heading), one batched gather + matmul for all
edge residuals, exact ``jax.jacfwd`` Jacobian, LM-damped dense Cholesky
on (7K, 7K) — trivial work at keyframe-graph sizes — and
Cauchy-IRLS attenuation of masked (loop) edges so one aliased revisit
cannot poison the solve.  Beyond-reference: the reference's mono path
has no pose chain at all (src/viso.cpp:1393-1396).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libviso_tpu.geometry.sim3 import (
    invert_sim3,
    matrix_to_sim3_vector,
    sim3_vector_to_matrix,
)


class Sim3GraphResult(NamedTuple):
    poses: jax.Array      # (T, 4, 4) optimized Sim(3) node poses
    cost0: jax.Array      # () initial weighted squared residual
    cost: jax.Array       # () final (both under the FINAL IRLS scaling)
    ok: jax.Array         # () bool — finite and non-increasing
    edge_scale: jax.Array  # (M,) final robust IRLS weight per edge


def optimize_sim3_graph(poses, edges_i, edges_j, z, weights=None,
                        iters: int = 10, damping: float = 1e-4,
                        robust: str = "cauchy", robust_mask=None,
                        robust_delta: float = 0.05,
                        scale_weight: float = 1.0):
    """LM-damped Gauss-Newton over the Sim(3) graph.

    Args match ``optimize_pose_graph`` (solvers/pose_graph.py) with:
      poses: (T, 4, 4) initial node poses — plain SE(3) matrices are
        valid Sim(3) with s = 1 (the normal initialization: VO knows no
        scale drift until a loop reveals it).
      z: (M, 4, 4) measured relative Sim(3), ``inv(S_i) S_j ~= z``.
      scale_weight: weight on the log-scale residual component relative
        to the rotation/translation components (log-scale is unitless;
        1.0 treats 1% of scale like 0.01 rad / 0.01 m of error).

    Returns Sim3GraphResult.  Fixed shapes; jit-compatible.
    """
    S0 = jnp.asarray(poses)
    Tn = S0.shape[0]
    edges_i = jnp.asarray(edges_i, jnp.int32)
    edges_j = jnp.asarray(edges_j, jnp.int32)
    z_inv = invert_sim3(jnp.asarray(z))
    M = edges_i.shape[0]
    if weights is None:
        weights = jnp.ones((M,), S0.dtype)
    w = jnp.sqrt(jnp.asarray(weights, S0.dtype))[:, None]      # (M, 1)
    comp_w = jnp.ones((7,), S0.dtype).at[6].set(scale_weight)
    if robust_mask is None:
        rmask = jnp.ones((M,), bool)
    else:
        rmask = jnp.asarray(robust_mask, bool)
    if robust == "none":
        rmask = jnp.zeros((M,), bool)
    elif robust not in ("cauchy", "huber"):
        raise ValueError(f"unknown robust kernel {robust!r}")

    def apply_delta(xf):
        xi = xf.reshape(Tn, 7)
        xi = xi.at[0].set(0.0)            # gauge: node 0 pinned
        return jnp.einsum("tij,tjk->tik", S0, sim3_vector_to_matrix(xi),
                          precision="highest")

    def edge_res(xf):
        """(M, 7) weighted per-edge residuals."""
        S = apply_delta(xf)
        rel = jnp.einsum("mij,mjk,mkl->mil", z_inv,
                         invert_sim3(S[edges_i]), S[edges_j],
                         precision="highest")
        return w * comp_w * matrix_to_sim3_vector(rel)

    def irls_scale(r7):
        s = jnp.sum(r7 * r7, axis=-1)
        d2 = robust_delta * robust_delta
        if robust == "huber":
            wr = jnp.minimum(1.0, jnp.sqrt(d2 / jnp.maximum(s, 1e-18)))
        else:  # cauchy
            wr = 1.0 / (1.0 + s / d2)
        return jnp.where(rmask, jnp.sqrt(wr), 1.0)

    def cost_of(xf, sc):
        r = (sc[:, None] * edge_res(xf)).reshape(-1)
        return jnp.sum(r * r)

    def gn_step(xf, _):
        # IRLS weights frozen per iteration; the step is judged under
        # the SAME frozen weights (see pose_graph.py::gn_step).
        sc = irls_scale(edge_res(xf))

        def flat_res(x):
            return (sc[:, None] * edge_res(x)).reshape(-1)

        r = flat_res(xf)                              # (7M,)
        J = jax.jacfwd(flat_res)(xf)                  # (7M, 7T)
        A = J.T @ r
        H = J.T @ J
        H = H + damping * jnp.diag(jnp.diag(H)) \
            + 1e-8 * jnp.eye(7 * Tn, dtype=xf.dtype)
        step = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(H), A)
        x_new = xf - step
        better = (jnp.isfinite(cost_of(x_new, sc))
                  & (cost_of(x_new, sc) <= cost_of(xf, sc)))
        return jnp.where(better, x_new, xf), None

    xf0 = jnp.zeros((7 * Tn,), S0.dtype)
    xf, _ = jax.lax.scan(gn_step, xf0, None, length=iters)
    sc = irls_scale(edge_res(xf))
    cost = cost_of(xf, sc)
    cost0 = cost_of(xf0, sc)   # same-scaling comparison, see pose_graph.py

    out = apply_delta(xf)
    ok = jnp.isfinite(cost) & (cost <= cost0)
    out = jnp.where(ok, out, S0)
    return Sim3GraphResult(poses=out, cost0=cost0, cost=cost, ok=ok,
                           edge_scale=sc * sc)


def reanchor_segments_sim3(poses_full, node_frames, node_sim3_opt):
    """Propagate optimized Sim(3) NODE poses to every frame in between.

    Frames in segment [node_k, node_{k+1}) keep their original rigid
    motion relative to node_k, transported through the node's Sim(3)
    correction: ``T_f' = se3( S'_k @ inv(P_k) @ T_f )`` — the node's
    scale factor multiplies the local translation offsets (drift-
    corrected segment lengths) and is then dropped off the rotation
    block (geometry/sim3.py::sim3_to_se3).

    Args:
      poses_full: (T, 4, 4) original SE(3) trajectory.
      node_frames: (K,) increasing frame indices of the graph nodes.
      node_sim3_opt: (K, 4, 4) optimized Sim(3) node poses.

    Returns (T, 4, 4) SE(3).
    """
    from libviso_tpu.geometry.se3 import invert_se3
    from libviso_tpu.geometry.sim3 import sim3_to_se3

    poses_full = jnp.asarray(poses_full)
    node_frames = jnp.asarray(node_frames, jnp.int32)
    Tn = poses_full.shape[0]
    seg = jnp.clip(
        jnp.searchsorted(node_frames, jnp.arange(Tn), side="right") - 1,
        0, node_frames.shape[0] - 1)
    anchor_old = poses_full[node_frames[seg]]          # (T, 4, 4) SE(3)
    anchor_new = jnp.asarray(node_sim3_opt)[seg]       # (T, 4, 4) Sim(3)
    fix = jnp.einsum("tij,tjk->tik", anchor_new, invert_se3(anchor_old),
                     precision="highest")
    return sim3_to_se3(jnp.einsum("tij,tjk->tik", fix, poses_full,
                                  precision="highest"))
