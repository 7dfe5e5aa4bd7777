"""Stereo triangulation (SURVEY.md C9, C10).

Both variants of the reference are provided:
  - ``triangulate_rectified``: the closed-form rectified-stereo inverse
    projection used by the main pipeline (src/viso.cpp:1137-1162 /
    src/mvg.cpp:172-192) — one fused elementwise op.
  - ``triangulate_dlt``: per-point 4x4 DLT via batched SVD
    (src/mvg.cpp:124-169) for unrectified camera pairs.
"""

from __future__ import annotations

import jax.numpy as jnp


def triangulate_rectified(x, f, base, cu, cv, min_disparity=1e-4):
    """Rectified-stereo triangulation of matched pixel observations.

    Args:
      x: (..., N, 4) observations (u_left, v_left, u_right, v_right) — the
        layout produced by ``collect_matches`` (src/viso.cpp:501-514).
      f, base, cu, cv: scalar calibration (focal, baseline, principal point).
      min_disparity: disparity clamp.  The template version the pipeline
        calls has no clamp (src/viso.cpp:1148); mvg.cpp:186 clamps at 1e-4.
        We clamp (padded/degenerate slots would otherwise produce inf that
        can poison downstream masked reductions).

    Returns:
      (..., N, 3) 3D points in the left camera frame:
        X = (u_l - cu) * b / d,  Y = (v_l - cv) * b / d,  Z = f * b / d.
    """
    x = jnp.asarray(x)
    d = jnp.maximum(x[..., 0] - x[..., 2], min_disparity)
    X = (x[..., 0] - cu) * base / d
    Y = (x[..., 1] - cv) * base / d
    Z = f * base / d
    return jnp.stack([X, Y, Z], axis=-1)


def triangulate_dlt(x1, x2, P1, P2, eps=1e-12):
    """Linear (DLT) triangulation for a general camera pair.

    Builds the per-point 4x4 system from the cross-product constraint
    x × (P X) = 0 (rows: u*P[2]-P[0], v*P[2]-P[1] for each view; reference
    src/mvg.cpp:136-161) and takes the right singular vector of least
    singular value — evaluated for all N points as one batched SVD, which
    XLA maps far better than the reference's per-point LAPACK calls.

    Args:
      x1, x2: (..., N, 2) pixel observations in each view.
      P1, P2: (..., 3, 4) camera matrices.

    Returns:
      (..., N, 3) dehomogenized 3D points.
    """
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    P1 = jnp.asarray(P1)[..., None, :, :]  # broadcast over N
    P2 = jnp.asarray(P2)[..., None, :, :]
    rows = [
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # (..., N, 4, 4)
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[..., -1, :]  # least-singular-value right singular vector
    w = Xh[..., 3:4]
    # Reference guards a vanishing homogeneous coordinate by dividing by 1
    # instead (src/mvg.cpp:163); mirror that behavior.
    w = jnp.where(jnp.abs(w) < eps, jnp.ones_like(w), w)
    return Xh[..., :3] / w
