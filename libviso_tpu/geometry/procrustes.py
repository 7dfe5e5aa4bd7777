"""3D-3D rigid alignment: Procrustes/Kabsch + vmapped RANSAC (SURVEY.md C14).

The reference's alternative pose estimator (src/estimation.cpp:29-51 with the
RANSAC wrapper src/viso.cpp:1101-1135).  Here the SVD is batched over RANSAC
hypotheses with ``vmap`` — all hypotheses solve simultaneously — and masked
weights replace ragged inlier subsets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from libviso_tpu.ops.topk import topk_auto


def solve_rigid_motion(A, B, weights=None):
    """Weighted orthogonal Procrustes: find R, t minimizing sum w |R b + t - a|^2.

    Convention matches the reference ``solveRigidMotion``
    (src/estimation.cpp:29-51): the returned transform maps the second cloud
    onto the first, ``T @ B ~= A``.

    Args:
      A: (..., N, 3) target points.
      B: (..., N, 3) source points.
      weights: optional (..., N) nonnegative weights (0 masks a point out).

    Returns:
      (..., 4, 4) rigid transform.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    if weights is None:
        weights = jnp.ones_like(A[..., 0])
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
    mean_a = jnp.sum(A * w, axis=-2, keepdims=True) / wsum
    mean_b = jnp.sum(B * w, axis=-2, keepdims=True) / wsum
    Ac = (A - mean_a) * jnp.sqrt(w)
    Bc = (B - mean_b) * jnp.sqrt(w)
    # Cross-covariance: rows of C follow the A axes, cols the B axes, so the
    # SVD factors give R mapping B-frame vectors into the A frame.
    C = jnp.einsum("...ni,...nj->...ij", Ac, Bc, precision="highest")
    U, _, Vt = jnp.linalg.svd(C)
    det = jnp.linalg.det(jnp.matmul(U, Vt, precision="highest"))
    D = jnp.zeros_like(U).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    D = D.at[..., 2, 2].set(det)
    R = jnp.matmul(jnp.matmul(U, D, precision="highest"), Vt, precision="highest")
    t = mean_a[..., 0, :] - jnp.einsum("...ij,...j->...i", R, mean_b[..., 0, :], precision="highest")
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def _apply(T, X):
    return jnp.einsum("...ij,...nj->...ni", T[..., :3, :3], X, precision="highest") + T[..., None, :3, 3]


def ransac_rigid_motion(key, A, B, valid=None, num_hypotheses=100,
                        inlier_thresh=0.1, model_size=3):
    """RANSAC over rigid alignments, all hypotheses as one vmapped batch.

    Mirrors the reference ``ransacRigidMotion`` (src/viso.cpp:1101-1135):
    N 3-point hypotheses, inliers are points with residual < thresh, best
    support set wins.  Batched: sampling uses the Gumbel-top-k trick over
    the validity mask, the Procrustes solve batches over the hypothesis axis.

    Args:
      key: jax PRNG key.
      A, B: (N, 3) clouds; solves T @ B ~= A.
      valid: optional (N,) mask of real (non-padded) points.
      num_hypotheses: RANSAC iterations (reference N=100, viso.cpp:1106).
      inlier_thresh: residual threshold (reference .1, viso.cpp:1123).
      model_size: points per sample (reference 3).

    Returns:
      (T_best (4,4), inlier_mask (N,), num_inliers ()).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    N = A.shape[0]
    if valid is None:
        valid = jnp.ones((N,), dtype=bool)

    # Sample `model_size` distinct valid indices per hypothesis.
    gumbel = jax.random.gumbel(key, (num_hypotheses, N))
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = topk_auto(scores, model_size)  # (H, model_size)

    sampleA = A[sample_idx]  # (H, model_size, 3)
    sampleB = B[sample_idx]
    T = solve_rigid_motion(sampleA, sampleB)  # (H, 4, 4)

    resid = jnp.sum((_apply(T, B[None]) - A[None]) ** 2, axis=-1)  # (H, N)
    inl = (resid < inlier_thresh**2) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)

    # Final refit on the best support set (masked weights, fixed shape).
    best_mask = inl[best]
    T_refit = solve_rigid_motion(A, B, weights=best_mask.astype(A.dtype))
    resid_f = jnp.sum((_apply(T_refit, B) - A) ** 2, axis=-1)
    final_mask = (resid_f < inlier_thresh**2) & valid
    return T_refit, final_mask, jnp.sum(final_mask)


def solve_similarity(A, B, weights=None):
    """Weighted Umeyama: find s, R, t minimizing sum w |s R b + t - a|^2.

    The Sim(3) extension of :func:`solve_rigid_motion` (same convention:
    the returned transform maps the second cloud onto the first,
    ``T @ B ~= A``, with the scale folded into the rotation block —
    geometry/sim3.py's matrix form).  This is the monocular loop-scale
    estimator: two visits to the same place carry landmark clouds in
    DIFFERENT drifted scale units, and the alignment's ``s`` measures
    exactly that ratio — observable even at the near-zero revisit
    baseline where two-view triangulation of the loop pair degenerates.
    Beyond-reference (the reference has no mono pose chain,
    src/viso.cpp:1393-1396; its 3D solver is rigid-only,
    src/estimation.cpp:29-51).

    Reference: S. Umeyama, "Least-squares estimation of transformation
    parameters between two point patterns", TPAMI 13(4), 1991.

    Args:
      A: (..., N, 3) target points.
      B: (..., N, 3) source points.
      weights: optional (..., N) nonnegative weights (0 masks out).

    Returns:
      (..., 4, 4) Sim(3) transform ``[[s R, t], [0, 1]]``.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    if weights is None:
        weights = jnp.ones_like(A[..., 0])
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
    mean_a = jnp.sum(A * w, axis=-2, keepdims=True) / wsum
    mean_b = jnp.sum(B * w, axis=-2, keepdims=True) / wsum
    Ac = (A - mean_a) * jnp.sqrt(w)
    Bc = (B - mean_b) * jnp.sqrt(w)
    C = jnp.einsum("...ni,...nj->...ij", Ac, Bc, precision="highest")
    U, sv, Vt = jnp.linalg.svd(C)
    det = jnp.linalg.det(jnp.matmul(U, Vt, precision="highest"))
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    D = jnp.zeros_like(U).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    D = D.at[..., 2, 2].set(det)
    R = jnp.matmul(jnp.matmul(U, D, precision="highest"), Vt,
                   precision="highest")
    # Umeyama: s = trace(diag(sv) D) / sum w |b - mean_b|^2
    var_b = jnp.maximum(jnp.sum(Bc * Bc, axis=(-2, -1)), 1e-12)
    s = jnp.sum(sv * d, axis=-1) / var_b
    t = mean_a[..., 0, :] - s[..., None] * jnp.einsum(
        "...ij,...j->...i", R, mean_b[..., 0, :], precision="highest")
    top = jnp.concatenate([s[..., None, None] * R, t[..., :, None]],
                          axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def ransac_similarity(key, A, B, valid=None, num_hypotheses=100,
                      inlier_thresh=0.1, model_size=3):
    """RANSAC over Sim(3) alignments, all hypotheses as one vmapped batch.

    Structure of :func:`ransac_rigid_motion` with the Umeyama solver:
    minimal 3-point samples (a point triple determines a similarity),
    consensus in the A-frame metric, masked refit on the best support.

    Returns (T_best (4,4) Sim(3), inlier_mask (N,), num_inliers ()).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    N = A.shape[0]
    if valid is None:
        valid = jnp.ones((N,), dtype=bool)

    gumbel = jax.random.gumbel(key, (num_hypotheses, N))
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = topk_auto(scores, model_size)  # (H, model_size)

    T = solve_similarity(A[sample_idx], B[sample_idx])  # (H, 4, 4)

    # _apply's rotation block carries s*R, so residuals are Sim(3)-exact
    resid = jnp.sum((_apply(T, B[None]) - A[None]) ** 2, axis=-1)
    inl = (resid < inlier_thresh**2) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)

    best_mask = inl[best]
    T_refit = solve_similarity(A, B, weights=best_mask.astype(A.dtype))
    resid_f = jnp.sum((_apply(T_refit, B) - A) ** 2, axis=-1)
    final_mask = (resid_f < inlier_thresh**2) & valid
    return T_refit, final_mask, jnp.sum(final_mask)


def solve_rigid_motion_horn(A, B, weights=None, power_iters: int = 14):
    """Closed-form weighted Kabsch via Horn's quaternion method — no SVD.

    Same contract as :func:`solve_rigid_motion` (finds T with
    ``T @ B ~= A``), but the rotation comes from the dominant eigenvector
    of Horn's symmetric 4x4 quaternion matrix, found by a fixed-length
    power iteration.  Everything is elementwise/tiny-matmul work that
    vmaps cleanly over RANSAC hypothesis batches — it avoids a batched
    ``jnp.linalg.svd`` on (H, 3, 3) problems, and the quaternion
    parameterization returns a PROPER rotation by construction (no det
    flip needed).  Near-degenerate samples (e.g.
    collinear triples) converge to an arbitrary rotation in their null
    space; RANSAC scoring rejects those hypotheses.

    Reference: B.K.P. Horn, "Closed-form solution of absolute orientation
    using unit quaternions", JOSA A 4(4), 1987.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    if weights is None:
        weights = jnp.ones_like(A[..., 0])
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)
    mean_a = jnp.sum(A * w, axis=-2, keepdims=True) / wsum
    mean_b = jnp.sum(B * w, axis=-2, keepdims=True) / wsum
    Ac = (A - mean_a) * jnp.sqrt(w)
    Bc = (B - mean_b) * jnp.sqrt(w)
    # Cross-covariance with rows over the A axes (as solve_rigid_motion).
    S = jnp.einsum("...ni,...nj->...ij", Ac, Bc, precision="highest")
    # The rotation depends only on S's direction — normalize so the
    # squaring chain below cannot overflow f32.  Without this, clouds
    # with ~1e6 coordinates (e.g. clamped-disparity false stereo matches
    # triangulated to ~f*b/1e-4) give S ~ 1e13, M@M ~ 1e26 and the
    # normalizer sum(M*M) -> inf, silently collapsing the quaternion to
    # zero and the rotation to identity.
    S = S / jnp.maximum(
        jnp.sqrt(jnp.sum(S * S, axis=(-2, -1), keepdims=True)), 1e-30)

    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    # Horn's N for R mapping the B frame onto the A frame.
    r0 = jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1)
    r1 = jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1)
    r2 = jnp.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1)
    r3 = jnp.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1)
    Nq = jnp.stack([r0, r1, r2, r3], axis=-2)          # (..., 4, 4)

    # Dominant eigenvector by shifted power iteration with repeated
    # SQUARING: |lambda(N)| <= sqrt(3)||S||_F, so N + s I is PSD with the
    # target eigenvalue on top; squaring k times raises the eigengap to
    # the 2^k-th power, so ~8 batched 4x4 matmuls reach machine
    # precision where plain power iteration needs hundreds of steps.
    shift = jnp.sqrt(3.0 * jnp.sum(S * S, axis=(-2, -1),
                                   keepdims=True)) + 1e-6
    M = Nq + shift * jnp.eye(4, dtype=Nq.dtype)
    # 3-point samples have rank-2 covariance, so the eigengap is 2*sigma2
    # — small for thin triangles; 14 squarings (effective power 2^14)
    # reach the f32 floor even at gap ratios ~0.995
    squarings = max(1, min(power_iters, 16))
    for _ in range(squarings):
        M = jnp.einsum("...ij,...jk->...ik", M, M, precision="highest")
        M = M / jnp.maximum(
            jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True)),
            1e-30)
    # M ~ v1 v1^T after squaring (symmetric), so its largest-norm COLUMN
    # is the dominant eigenvector — immune to the classic power-iteration
    # failure where a fixed start vector is (near-)orthogonal to v1
    # (e.g. rotations near 180 deg whose quaternion has qw ~ 0).
    col_norm2 = jnp.sum(M * M, axis=-2)                    # (..., 4)
    best = jnp.argmax(col_norm2, axis=-1)
    v = jnp.take_along_axis(
        M, best[..., None, None].repeat(4, axis=-2), axis=-1)[..., 0]
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    # With S laid out rows-over-A-axes, this N recovers the A->B
    # rotation; conjugating the quaternion gives the B->A map we return.
    qw, qx, qy, qz = v[..., 0], -v[..., 1], -v[..., 2], -v[..., 3]

    R = jnp.stack([
        jnp.stack([1 - 2 * (qy * qy + qz * qz),
                   2 * (qx * qy - qw * qz),
                   2 * (qx * qz + qw * qy)], -1),
        jnp.stack([2 * (qx * qy + qw * qz),
                   1 - 2 * (qx * qx + qz * qz),
                   2 * (qy * qz - qw * qx)], -1),
        jnp.stack([2 * (qx * qz - qw * qy),
                   2 * (qy * qz + qw * qx),
                   1 - 2 * (qx * qx + qy * qy)], -1),
    ], axis=-2)

    t = mean_a[..., 0, :] - jnp.einsum("...ij,...j->...i", R,
                                       mean_b[..., 0, :],
                                       precision="highest")
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)
