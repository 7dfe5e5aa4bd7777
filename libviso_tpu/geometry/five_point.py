"""Nister 5-point essential-matrix solver, batched (SURVEY.md C3).

The reference's mono path relies on OpenCV's ``findEssentialMat`` — the
Nister 5-point minimal solver inside RANSAC (src/viso.cpp:1384).  The
classical implementation is hostile to accelerators: symbolic Gauss-Jordan
with row pivoting and companion-matrix eigenvalues.  This module re-derives
it with batched, fixed-shape numerics only:

  1. The 4-dim nullspace of the 5x9 epipolar system (batched SVD) gives
     E(x, y, z) = x E1 + y E2 + z E3 + E4.
  2. The ten cubic constraints (det E = 0 and 2 E E'E - tr(E E') E = 0)
     are polynomials in (x, y, z) over 20 monomials.  Their coefficient
     matrix M (10, 20) is recovered by EXACT POLYNOMIAL INTERPOLATION:
     evaluate the constraints at 20 fixed well-conditioned nodes and
     multiply by a precomputed inverse Vandermonde — no symbolic expansion
     in sight, and the construction is trivially vmappable.
  3. Gauss-Jordan reduction is one batched 10x10 solve.  Nister's three
     cancelling row pairs (x^2 z, x^2), (y^2 z, y^2), (xyz, xy) yield the
     3x3 polynomial matrix B(z); det B(z) is a degree-10 polynomial
     assembled by coefficient convolutions.
  4. Real roots come from a sign-change scan over a tangent-spaced grid
     on the Cauchy-bound interval (dense near zero, where the roots
     cluster) followed by fixed-iteration bisection + Newton polish, plus
     |p| local-minimum harvesting for near-double roots — `lax`-friendly,
     no eigensolver.
  5. Each root slot back-substitutes to (x, y) through the numerically
     best row pair of B(z), then a damped Gauss-Newton polish on the raw
     constraint residuals (3 unknowns) repairs f32 pipeline noise; a few
     fixed auxiliary GN basins rescue merged roots.  Up to 22 candidates
     (+ validity mask) per sample are returned, fixed shape; spurious
     slots are rejected by a constraint-residual check.

Monomial order (Nister 2004):
  m = [x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y]
  n = [x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.geometry.mvg import e2h

# ---------------------------------------------------------------------------
# Host-side constants: monomials, interpolation nodes, inverse Vandermonde.
# ---------------------------------------------------------------------------

_EXPONENTS = np.array([
    # m (eliminated) monomials
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    # n (retained) monomials
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
], dtype=np.int64)


def _make_nodes_and_vinv():
    """20 interpolation nodes + inverse Vandermonde (f64, once, on host)."""
    rng = np.random.default_rng(12345)
    best = None
    for _ in range(200):  # pick the best-conditioned random node set
        nodes = rng.uniform(-1.0, 1.0, (20, 3))
        V = np.prod(nodes[:, None, :] ** _EXPONENTS[None, :, :], axis=-1)
        c = np.linalg.cond(V)
        if best is None or c < best[0]:
            best = (c, nodes, V)
    _, nodes, V = best
    return nodes, np.linalg.inv(V)


_NODES, _VINV = _make_nodes_and_vinv()


# ---------------------------------------------------------------------------
# Constraint evaluation and the 10x20 coefficient matrix.
# ---------------------------------------------------------------------------

def _constraints(E):
    """The 10 Nister constraint values of a 3x3 matrix (batched).

    c0 = det(E); c1..c9 = vec(2 E E' E - tr(E E') E) row-major.
    """
    det = jnp.linalg.det(E)
    EEt = jnp.matmul(E, jnp.swapaxes(E, -1, -2), precision="highest")
    tr = jnp.trace(EEt, axis1=-2, axis2=-1)
    C = (2.0 * jnp.matmul(EEt, E, precision="highest")
         - tr[..., None, None] * E)
    return jnp.concatenate(
        [det[..., None], C.reshape(C.shape[:-2] + (9,))], axis=-1)


def _coefficient_matrix(basis):
    """(..., 10, 20) polynomial coefficients of the constraints.

    Args:
      basis: (..., 4, 3, 3) nullspace basis (E1, E2, E3, E4).
    """
    dtype = basis.dtype
    nodes = jnp.asarray(_NODES, dtype)                        # (20, 3)
    coeffs = jnp.concatenate(
        [nodes, jnp.ones(nodes.shape[:-1] + (1,), dtype)], axis=-1)  # (20,4)
    # E at every node: (..., 20, 3, 3)
    En = jnp.einsum("ka,...aij->...kij", coeffs, basis, precision="highest")
    vals = _constraints(En)                                   # (..., 20, 10)
    vinv = jnp.asarray(_VINV, dtype)                          # (20, 20)
    # row r of M solves V @ M_r = vals[:, r]  ->  M = (Vinv @ vals).T
    M_t = jnp.einsum("jk,...ki->...ji", vinv, vals, precision="highest")
    return jnp.swapaxes(M_t, -1, -2)


# ---------------------------------------------------------------------------
# B(z) and its determinant polynomial.
# ---------------------------------------------------------------------------

def _b_polys(C):
    """Polynomial entries of Nister's 3x3 B(z) from the reduced system.

    Args:
      C: (..., 10, 10) with m_r + sum_j C[r, j] n_j = 0 after reduction.

    Returns (Bx, By, B1): coefficient tensors (..., 3, 4), (..., 3, 4),
    (..., 3, 5), ascending powers of z, one row per cancelling pair.
    """
    pairs = ((4, 5), (6, 7), (8, 9))  # (x^2 z, x^2), (y^2 z, y^2), (xyz, xy)
    bx, by, b1 = [], [], []
    for r1, r2 in pairs:
        c1 = C[..., r1, :]
        c2 = C[..., r2, :]
        # eq: sum_j (z c2[j] - c1[j]) n_j = 0
        # x coefficient over n[0..2] = [x z^2, x z, x]:
        bx.append(jnp.stack([-c1[..., 2],
                             c2[..., 2] - c1[..., 1],
                             c2[..., 1] - c1[..., 0],
                             c2[..., 0]], axis=-1))
        # y coefficient over n[3..5] = [y z^2, y z, y]:
        by.append(jnp.stack([-c1[..., 5],
                             c2[..., 5] - c1[..., 4],
                             c2[..., 4] - c1[..., 3],
                             c2[..., 3]], axis=-1))
        # constant over n[6..9] = [z^3, z^2, z, 1]:
        b1.append(jnp.stack([-c1[..., 9],
                             c2[..., 9] - c1[..., 8],
                             c2[..., 8] - c1[..., 7],
                             c2[..., 7] - c1[..., 6],
                             c2[..., 6]], axis=-1))
    return (jnp.stack(bx, axis=-2), jnp.stack(by, axis=-2),
            jnp.stack(b1, axis=-2))


def _polymul(a, b):
    """Coefficient convolution of ascending-power polynomials (batched)."""
    la, lb = a.shape[-1], b.shape[-1]
    out = jnp.zeros(jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
                    + (la + lb - 1,), a.dtype)
    for i in range(la):  # static tiny loop: unrolled at trace time
        out = out.at[..., i:i + lb].add(a[..., i:i + 1] * b)
    return out


def _det_poly(Bx, By, B1):
    """Degree-10 det B(z) coefficients (..., 11), ascending powers."""
    def row(i):
        return Bx[..., i, :], By[..., i, :], B1[..., i, :]

    x0, y0, c0 = row(0)
    x1, y1, c1 = row(1)
    x2, y2, c2 = row(2)
    # cofactor expansion along row 0 of [[x0, y0, c0], [x1, y1, c1], ...]
    m00 = _polymul(y1, c2) - _polymul(y2, c1)   # deg 7 (8)
    m01 = _polymul(x1, c2) - _polymul(x2, c1)   # deg 7 (8)
    m02 = _polymul(x1, y2) - _polymul(x2, y1)   # deg 6 (7)
    det = (_polymul(x0, m00) - _polymul(y0, m01))        # deg 10 (11)
    det = det + jnp.pad(_polymul(c0, m02),
                        [(0, 0)] * (det.ndim - 1) + (
                            [(0, det.shape[-1] - c0.shape[-1]
                              - m02.shape[-1] + 1)]))
    return det


# ---------------------------------------------------------------------------
# Real roots of a degree-10 polynomial: grid bracketing + bisection.
# ---------------------------------------------------------------------------

def _polyval(coeffs, z):
    """Horner evaluation, ascending coefficients (static length)."""
    acc = jnp.zeros_like(z) + coeffs[..., -1:]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        acc = acc * z + coeffs[..., i:i + 1]
    return acc


def real_roots_deg10(coeffs, grid_size: int = 512, bisect_iters: int = 12,
                     newton_iters: int = 4, max_bound: float = 100.0):
    """Up to 10 real roots of a degree-10 polynomial (batched, fixed shape).

    Sign changes over a TANGENT-spaced grid on [-R, R] (R = clamped Cauchy
    bound) seed bisection brackets.  Bisection only needs to reach the
    Newton basin: central brackets start ~R/256 wide (the tan grid's
    outermost intervals are far wider, ~0.6R at bound=100, but Newton's
    basin for the simple large-|z| roots covers what 12 halvings leave);
    the quadratic Newton polish does the rest.  (The
    mono frame time is insensitive to the bisection depth — the cost
    lives in the candidate scoring — but fewer sequential steps is
    strictly better.)  The tan spacing is densest near zero —
    where 5-point roots cluster, since the nullspace coordinates are
    normalized to w=1 — and sparse toward the bound; a Chebyshev grid has
    exactly the wrong density profile here (dense at +-R) and misses close
    root pairs near the origin.  Roots between same-sign grid points
    (even-multiplicity pairs closer than the local spacing) are still
    missed, and f32 evaluation chatter near the noise floor can burn
    bracket slots on spurious crossings — both acceptable inside RANSAC,
    where a lost candidate costs one sample out of 64.

    Returns (roots (..., 14), valid (..., 14)): 10 sign-change
    slots + 4 local-minimum slots.
    """
    dtype = coeffs.dtype
    scale = jnp.max(jnp.abs(coeffs), axis=-1, keepdims=True)
    c = coeffs / jnp.maximum(scale, 1e-30)
    lead = c[..., -1]
    bound = 1.0 + jnp.max(jnp.abs(c[..., :-1]), axis=-1) / jnp.maximum(
        jnp.abs(lead), 1e-6)
    bound = jnp.minimum(bound, max_bound)

    k = jnp.arange(grid_size, dtype=dtype)
    tmax = jnp.arctan(bound)                                     # (...,)
    theta = (2.0 * k / (grid_size - 1) - 1.0)                    # [-1, 1]
    z = jnp.tan(tmax[..., None] * theta)                         # (..., K)
    p = _polyval(c, z)
    sign_change = (p[..., :-1] * p[..., 1:]) < 0                 # (..., K-1)

    # first 10 bracket indices, fixed shape (invalid slots -> garbage,
    # masked by `valid`)
    idxf = jnp.arange(grid_size - 1, dtype=dtype)
    score = jnp.where(sign_change, -idxf, -jnp.inf)
    _, top = jax.lax.top_k(score, 10)                            # (..., 10)
    valid = jnp.take_along_axis(sign_change, top, axis=-1)

    lo = jnp.take_along_axis(z, top, axis=-1)
    hi = jnp.take_along_axis(z, top + 1, axis=-1)
    plo = _polyval(c, lo)

    def bisect(_, state):
        lo, hi, plo = state
        mid = 0.5 * (lo + hi)
        pm = _polyval(c, mid)
        left = (plo * pm) <= 0
        return (jnp.where(left, lo, mid), jnp.where(left, mid, hi),
                jnp.where(left, plo, pm))

    lo, hi, _ = jax.lax.fori_loop(0, bisect_iters, bisect, (lo, hi, plo))
    root = 0.5 * (lo + hi)

    # Newton polish (derivative coefficients are static)
    dc = c[..., 1:] * jnp.arange(1, c.shape[-1], dtype=dtype)
    for _ in range(newton_iters):
        f = _polyval(c, root)
        df = _polyval(dc, root)
        step = f / jnp.where(jnp.abs(df) > 1e-20, df, jnp.inf)
        root = jnp.where(jnp.abs(step) < 1.0, root - step, root)

    # Near-double roots produce NO sign change — they show as small local
    # minima of |p| instead.  Harvest the 4 deepest interior local minima
    # as extra candidate roots (the downstream constraint check rejects
    # spurious ones).
    ap = jnp.abs(p)
    interior = (ap[..., 1:-1] <= ap[..., :-2]) & (ap[..., 1:-1]
                                                  <= ap[..., 2:])
    lm_score = jnp.where(interior, -ap[..., 1:-1], -jnp.inf)
    _, lm_top = jax.lax.top_k(lm_score, 4)
    lm_root = jnp.take_along_axis(z[..., 1:-1], lm_top, axis=-1)
    lm_valid = jnp.take_along_axis(interior, lm_top, axis=-1)
    root = jnp.concatenate([root, lm_root], axis=-1)           # (..., 14)
    valid = jnp.concatenate([valid, lm_valid], axis=-1)
    return root, valid


# ---------------------------------------------------------------------------
# Public solver.
# ---------------------------------------------------------------------------

def five_point_E(x1, x2):
    """Essential-matrix candidates from exactly 5 normalized correspondences.

    Args:
      x1, x2: (..., 5, 2) normalized coordinates with x2' E x1 = 0.

    Returns:
      E: (..., 22, 3, 3) candidate essential matrices (Frobenius-normalized):
        10 sign-change root slots + 4 |p| local-minimum slots + 8 auxiliary
        GN-polish basins.
      valid: (..., 22) bool — slots that produced a constraint-satisfying
        candidate (residual-checked).
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    h1 = e2h(x1)
    h2 = e2h(x2)
    Q = jnp.einsum("...ni,...nj->...nij", h2, h1, precision="highest").reshape(
        x1.shape[:-1] + (9,))                                  # (..., 5, 9)
    _, _, vt = jnp.linalg.svd(Q, full_matrices=True)
    basis = vt[..., 5:9, :].reshape(x1.shape[:-2] + (4, 3, 3))
    # Basis order: jnp.linalg.svd returns singular values DESCENDING, so
    # row 8 is the smallest-σ vector; the reversal makes E4 (the affine
    # term, coefficient fixed at 1) the LARGEST-σ of the four nullspace
    # vectors.  Any order is mathematically equivalent; this one is kept
    # because it validates best end-to-end (oracle recovery and the mono
    # pipeline accuracy tests are both sensitive to the f32 conditioning
    # of the M1 solve, and this order wins on the latter).
    basis = basis[..., ::-1, :, :]                             # E1..E4

    M = _coefficient_matrix(basis)                             # (..., 10, 20)
    M1 = M[..., :, :10]
    M2 = M[..., :, 10:]
    # guard singular leading blocks (degenerate samples)
    detM1 = jnp.linalg.det(M1)
    gj_ok = jnp.abs(detM1) > 1e-30
    M1_safe = jnp.where(gj_ok[..., None, None], M1,
                        jnp.eye(10, dtype=M.dtype))
    C = jnp.linalg.solve(M1_safe, M2)                          # (..., 10, 10)

    Bx, By, B1 = _b_polys(C)
    det = _det_poly(Bx, By, B1)                                # (..., 11)
    z, z_valid = real_roots_deg10(det)                         # (..., 14)

    # back-substitute each root slot: B(z) [x, y, 1]' = 0
    def eval_rows(P, z):
        # P: (..., 3, L) ascending coeffs; z: (..., K) -> (..., K, 3)
        zz = z[..., :, None]                                   # (..., K, 1)
        out = jnp.zeros(z.shape + (3,), P.dtype) + P[..., None, :, -1]
        for i in range(P.shape[-1] - 2, -1, -1):
            out = out * zz + P[..., None, :, i]
        return out

    bx = eval_rows(Bx, z)                                      # (..., 14, 3)
    by = eval_rows(By, z)
    b1 = eval_rows(B1, z)
    B = jnp.stack([bx, by, b1], axis=-1)                       # (...,14,3,3)
    # null vector of B via the largest cross product of two rows
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = jnp.stack([jnp.cross(r0, r1), jnp.cross(r0, r2),
                       jnp.cross(r1, r2)], axis=-2)            # (...,14,3,3)
    norms = jnp.linalg.norm(cands, axis=-1)
    pickc = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, pickc[..., None, None],
                            axis=-2)[..., 0, :]                # (..., 14, 3)
    w = v[..., 2]
    w_ok = jnp.abs(w) > 1e-12
    w_safe = jnp.where(w_ok, w, 1.0)
    xy = v[..., :2] / w_safe[..., None]                        # (..., 14, 2)

    xyz = jnp.concatenate([xy, z[..., None]], axis=-1)         # (..., 14, 3)
    root_valid = z_valid & w_ok & gj_ok[..., None]

    # Auxiliary GN basins: the f32 coefficient pipeline occasionally merges
    # close real roots; a handful of fixed extra starting points recovers
    # solutions whose root slot was lost.  Invalid/garbage basins are
    # rejected by the constraint-residual check below.
    extra = jnp.asarray(_EXTRA_STARTS, xyz.dtype)
    extra = jnp.broadcast_to(extra, xyz.shape[:-2] + extra.shape)
    # Split polish budgets: root slots start within ~1e-3 of a solution
    # (bisection+Newton already ran) and converge in a few steps, while
    # the auxiliary basins start far away — polishing everything at the
    # basin budget doubled the whole solver's cost.
    xyz = _polish_xyz(basis, xyz, iters=3)
    extra = _polish_xyz(basis, extra, iters=8)
    xyz = jnp.concatenate([xyz, extra], axis=-2)               # (..., 22, 3)

    ones = jnp.ones(xyz.shape[:-1] + (1,), xyz.dtype)
    coeff = jnp.concatenate([xyz, ones], axis=-1)
    E = jnp.einsum("...ka,...aij->...kij", coeff, basis,
                   precision="highest")                          # (...,22,3,3)
    E = E / jnp.maximum(
        jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1),
        1e-30)[..., None, None]
    # accept only candidates that actually solve the constraints
    res = jnp.linalg.norm(_constraints(E), axis=-1)            # (..., 22)
    n_extra = _EXTRA_STARTS.shape[0]
    slot_valid = jnp.concatenate(
        [root_valid,
         jnp.broadcast_to(gj_ok[..., None], root_valid.shape[:-1]
                          + (n_extra,))], axis=-1)
    valid = slot_valid & (res < 1e-3)
    return E, valid


# GN starting points for the auxiliary polish basins (see five_point_E).
_EXTRA_STARTS = np.array([
    (0.0, 0.0, 0.0), (0.5, 0.3, 0.2), (-0.5, 0.3, -0.2),
    (1.0, -1.0, 0.5), (-1.0, 1.0, -0.5), (2.0, 2.0, -1.0),
    (3.0, -3.0, 1.0), (-3.0, 3.0, -1.0),
], dtype=np.float64)


def _polish_xyz(basis, xyz, iters: int = 4, damping: float = 1e-8):
    """Gauss-Newton refinement of nullspace coordinates on the constraints.

    The f32 coefficient pipeline (interpolation -> 10x10 solve -> degree-10
    determinant) shifts roots by up to ~1e-3; a few GN steps on the raw
    constraint residuals c(E(x, y, z)) (scale-normalized) pull every
    candidate back to machine precision.  3 unknowns, 10 residuals, tiny.

    Args:
      basis: (..., 4, 3, 3); xyz: (..., K, 3) candidate coordinates.
    """
    def resid(c3, basis_):
        coeff4 = jnp.concatenate([c3, jnp.ones_like(c3[..., :1])], axis=-1)
        E = jnp.einsum("a,aij->ij", coeff4, basis_, precision="highest")
        nrm = jnp.maximum(jnp.linalg.norm(E.reshape(9)), 1e-30)
        return _constraints(E / nrm)

    def step(c3, basis_):
        r = resid(c3, basis_)
        J = jax.jacfwd(resid)(c3, basis_)            # (10, 3)
        A = (jnp.matmul(J.T, J, precision="highest")
             + damping * jnp.eye(3, dtype=c3.dtype))
        g = jnp.matmul(J.T, r, precision="highest")
        d = jnp.linalg.solve(A, g)
        c_new = c3 - d
        better = (jnp.sum(resid(c_new, basis_) ** 2) < jnp.sum(r ** 2))
        return jnp.where(better, c_new, c3)

    def polish_one(c3, basis_):
        for _ in range(iters):
            c3 = step(c3, basis_)
        return c3

    flat_shape = xyz.shape
    b_b = jnp.broadcast_to(basis[..., None, :, :, :],
                           flat_shape[:-1] + basis.shape[-3:])
    fn = polish_one
    for _ in range(xyz.ndim - 1):
        fn = jax.vmap(fn)
    return fn(xyz, b_b)
