"""Small-k exact top-k without the sort (shared hot-path helper).

``lax.top_k`` may lower to a partial SORT of each row — O(M log M) or
worse data movement that dominates when only a handful of winners are
kept (the detector's per-bin corner budget, RANSAC's Gumbel
``model_size`` draws).  For small k, k rounds of (argmax, mask) are
exact and bit-identical to ``lax.top_k`` — both break ties by LOWEST
index — while moving ~k linear passes of data that XLA fuses into the
surrounding pipeline (the detector's (120, 3825) bin top-k is the main
user).  Its speed on the GPU against ``lax.top_k`` is not measured.

Tie/edge semantics (tested, tests/test_features.py):
  - equal values come out in ascending-index order, like ``lax.top_k``;
  - the ONE divergence is rows whose remaining elements are all -inf
    (argmax of an all--inf row returns index 0 every round, top_k
    returns ascending indices) — impossible for the in-tree callers
    (detector rows are |response| >= 0; Gumbel scores are finite on
    valid slots and the callers clamp/mask invalid winners anyway).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# cap for the k-pass scheme: it is linear in k, so a sort wins
# asymptotically; the in-tree budgets are k <= 16
ITERATIVE_MAX_K = 16


def topk_iterative(x, k):
    """Exact row-wise (values, indices) top-k by k rounds of argmax+mask;
    bit-identical to ``lax.top_k`` for finite inputs (see module note)."""
    cols = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    neg_inf = jnp.asarray(-jnp.inf, x.dtype)
    vals, idxs = [], []
    b = x
    for _ in range(k):
        i = jnp.argmax(b, axis=-1).astype(jnp.int32)
        vals.append(jnp.take_along_axis(b, i[..., None], -1)[..., 0])
        idxs.append(i)
        b = jnp.where(cols == i[..., None], neg_inf, b)
    return jnp.stack(vals, -1), jnp.stack(idxs, -1)


def topk_auto(x, k):
    """``lax.top_k`` semantics, choosing the cheaper implementation."""
    if k <= ITERATIVE_MAX_K:
        return topk_iterative(x, k)
    return jax.lax.top_k(x, k)
