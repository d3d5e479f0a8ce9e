"""Row gathers for small tables.

A renderer gathers per ray from small tables (material rows, light rows,
per-primitive ids, triangle vertices of a small scene). `gather_rows`
picks the form by table size: an unrolled where-chain for N ≤ MAX_SELECT
(it fuses into its consumers with no (R, N) intermediate), a one-hot
matmul `onehot(idx, N) @ table` for N ≤ `max_onehot`, and the plain take
above it (the BVH path gathers per node, not per ray). The forms avoid
per-ray index gathers, which were the slow operation on the accelerator
this code was first written for; whether they still beat a plain take on
the GPU is not measured yet (ROADMAP Speed 7). Integer/bool tables ride
the same matmul (values < 2^24 are exact in f32 — all id/tag tables
qualify); wider integers (e.g. Sobol matrices) must keep plain takes.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

Array = Any

MAX_ONEHOT = 512
# below this row count an unrolled where-chain beats the one-hot matmul:
# it fuses into consumers with no (R,N) intermediate or relayout copies
MAX_SELECT = 32
# peak bytes allowed for the (R, N) f32 one-hot intermediate; above this the
# matmul is chunked over R so a 2M-ray × 512-row gather cannot materialize
# multi-GB one-hot matrices in device memory
ONEHOT_BUDGET_BYTES = 128 << 20


def _apply_select(idx: Array, leaf: Array) -> Array:
    """Unrolled where-chain gather: leaf (N, ...), idx (R,) → (R, ...)."""
    n = leaf.shape[0]
    cond_shape = idx.shape + (1,) * (leaf.ndim - 1)
    out = jnp.broadcast_to(leaf[0], idx.shape + leaf.shape[1:])
    for j in range(1, n):
        out = jnp.where((idx == j).reshape(cond_shape), leaf[j], out)
    return out


def _apply_onehot(oh: Array, leaf: Array) -> Array:
    """(R,N) one-hot @ (N,...) table → (R,...), dtype-preserving.

    The dots run at Precision.HIGHEST: at default precision a float32 dot
    may round its operands (TF32 on a GPU keeps about three decimal
    digits), which would silently corrupt every gathered table value in
    the 33..512-row window — and round integer ids > 256 to a WRONG row
    after rint. The one-hot side is exact 0/1 either way; HIGHEST keeps
    the table side full f32.
    """
    n = leaf.shape[0]
    flat = leaf.reshape(n, -1)
    hi = jax.lax.Precision.HIGHEST
    if leaf.dtype == jnp.bool_:
        out = jnp.matmul(oh, flat.astype(jnp.float32), precision=hi)
        out = out > 0.5
    elif jnp.issubdtype(leaf.dtype, jnp.integer):
        out = jnp.matmul(oh, flat.astype(jnp.float32), precision=hi)
        out = jnp.rint(out).astype(leaf.dtype)
    else:
        out = jnp.matmul(oh, flat.astype(jnp.float32),
                         precision=hi).astype(leaf.dtype)
    return out.reshape(oh.shape[:1] + leaf.shape[1:])


def _onehot_gather(idx: Array, leaf: Array) -> Array:
    """One-hot-matmul gather, chunked over R when the (R, N) one-hot would
    exceed ONEHOT_BUDGET_BYTES (bounds peak device memory; total traffic
    unchanged)."""
    r, n = idx.shape[0], leaf.shape[0]
    if r * n * 4 <= ONEHOT_BUDGET_BYTES:
        return _apply_onehot(jax.nn.one_hot(idx, n, dtype=jnp.float32), leaf)
    chunk = max(8, ONEHOT_BUDGET_BYTES // (n * 4))
    outs = [
        _apply_onehot(
            jax.nn.one_hot(idx[s:s + chunk], n, dtype=jnp.float32), leaf)
        for s in range(0, r, chunk)
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def gather_rows(table: Array, idx: Array, max_onehot: int = MAX_ONEHOT
                ) -> Array:
    """`table[idx]` for idx (R,) int — one-hot matmul when the table is
    small, plain take otherwise.
    idx is clipped into range."""
    n = table.shape[0]
    idx = jnp.clip(idx, 0, n - 1)
    if n > max_onehot or idx.ndim != 1:
        return table[idx]
    if n <= MAX_SELECT:
        return _apply_select(idx, table)
    return _onehot_gather(idx, table)


def make_row_gather(n: int, idx: Array, max_onehot: int = MAX_ONEHOT):
    """Return g(a) gathering rows idx from any (n, ...) array, sharing one
    one-hot matrix across calls (small n) or plain takes (large n)."""
    idx = jnp.clip(idx, 0, n - 1)
    if idx.ndim == 1 and n <= MAX_SELECT:
        return lambda a: _apply_select(idx, a)
    if idx.ndim == 1 and n <= max_onehot:
        if idx.shape[0] * n * 4 <= ONEHOT_BUDGET_BYTES:
            oh = jax.nn.one_hot(idx, n, dtype=jnp.float32)
            return lambda a: _apply_onehot(oh, a)
        return lambda a: _onehot_gather(idx, a)
    return lambda a: a[idx]


def gather_tree(tree, idx: Array, n: int, max_onehot: int = MAX_ONEHOT):
    """Gather rows idx from every (n, ...) leaf of a pytree via the
    fastest applicable strategy; leaves whose leading dim ≠ n pass
    through unchanged."""
    g = make_row_gather(n, idx, max_onehot)
    return jax.tree_util.tree_map(
        lambda a: g(a) if (hasattr(a, "shape") and a.ndim >= 1
                           and a.shape[0] == n) else a, tree)


def select_component(v: Array, ax: Array) -> Array:
    """v[..., ax] for a per-element axis index ax ∈ {0..C-1}: one-hot dot
    instead of take_along_axis's per-element index gather."""
    c = v.shape[-1]
    oh = jax.nn.one_hot(ax, c, dtype=v.dtype if jnp.issubdtype(
        v.dtype, jnp.floating) else jnp.float32)
    out = jnp.sum(v * oh, axis=-1)
    return out if jnp.issubdtype(v.dtype, jnp.floating) \
        else jnp.rint(out).astype(v.dtype)


def select_row(v: Array, idx: Array) -> Array:
    """v[r, idx[r]] for v (R, M, ...) with small M: unrolled where-chain
    over the M slots (replaces advanced-index gathers; fuses fully)."""
    m = v.shape[1]
    cond_shape = idx.shape + (1,) * (v.ndim - 2)
    out = v[:, 0]
    for j in range(1, m):
        out = jnp.where((idx == j).reshape(cond_shape), v[:, j], out)
    return out


def select_along_last(v: Array, idx: Array) -> Array:
    """take_along_axis(v, idx[..., None], -1)[..., 0] without the gather:
    one-hot dot over the last axis (use when that axis is small — P
    primitives of one family, C components)."""
    return select_component(v, idx)
