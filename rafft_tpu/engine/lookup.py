"""Table lookups as one-hot contractions or gathers.

The engine was first tuned on a backend whose computed-index gathers
were far slower than a one-hot contraction, where XLA fuses the
iota-compare one-hot into the dot.  Whether that trade holds on the GPU
is not measured yet.  These helpers pick the formulation by static
shape:

* one-hot einsum for small tables x large index sets (exact: the
  one-hot dot multiplies each value by exactly 1.0 or 0.0, so any int32
  value with |v| < 2^24 survives f32 untouched);
* plain gather for big tables (one-hot flops would dominate) or small
  index sets (gather overhead is negligible there).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# one-hot einsum when the index set is large and the table is small
_MIN_IDX = 1 << 14
_MAX_TAB = 2048

# trace-time escape hatch for vmap blindness: under jax.vmap the lookup
# sees the UNBATCHED index shape, so a per-candidate [N] lookup inside a
# 512-wide vmap picks the gather path even though the real index volume
# is huge.  Callers that vmap over a large axis set this flag around the
# vmapped call (it only matters at trace time).
_ASSUME_BATCHED = False


class assume_batched:
    """Context manager: treat every lookup as large-index while tracing."""

    def __enter__(self):
        global _ASSUME_BATCHED
        self._prev = _ASSUME_BATCHED
        _ASSUME_BATCHED = True

    def __exit__(self, *exc):
        global _ASSUME_BATCHED
        _ASSUME_BATCHED = self._prev
        return False


def _nelem(x) -> int:
    if _ASSUME_BATCHED:
        return 1 << 30
    return int(np.prod(x.shape)) if x.shape else 1


def flat_lookup(flat, lin):
    """flat[lin] with the fast formulation chosen by static shape.

    flat: 1-D values (int32/f32), lin: any-shape int32 indices assumed
    in-range."""
    n = flat.shape[0]
    if _nelem(lin) < _MIN_IDX or n > _MAX_TAB:
        return flat[lin]
    oh = (lin[..., None] == jnp.arange(n, dtype=lin.dtype)).astype(jnp.float32)
    # HIGHEST precision is required for exactness: a default-precision
    # f32 dot may round operands through bf16 or TF32, corrupting any
    # value that needs more mantissa bits (e.g. 751 -> 752)
    out = jnp.einsum('...n,n->...', oh, flat.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(flat.dtype)


def table_lookup(table, *idx):
    """table[idx0, idx1, ...] (multi-index) via flat_lookup."""
    strides = np.cumprod((1,) + table.shape[:0:-1])[::-1]
    lin = idx[0] * int(strides[0])
    for s, ix in zip(strides[1:], idx[1:]):
        lin = lin + ix * int(s)
    return flat_lookup(table.reshape(-1), lin)


def batched_taa(tab, idx):
    """take_along_axis(tab, idx, axis=-1) where tab is [..., X] and idx
    is [..., M] with the same leading dims — as a one-hot einsum when
    the index set is large (as flat_lookup).

    Exact for integer values |v| < 2^24 and any f32 values (selection
    multiplies by exactly 0.0/1.0)."""
    X = tab.shape[-1]
    if _nelem(idx) < _MIN_IDX or X > _MAX_TAB:
        return jnp.take_along_axis(tab, idx, axis=-1)
    oh = (idx[..., None] == jnp.arange(X, dtype=idx.dtype)).astype(jnp.float32)
    # HIGHEST: see flat_lookup — default-precision f32 dots round
    out = jnp.einsum('...mx,...x->...m', oh, tab.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(tab.dtype)


def row_lookup(tab, idx):
    """tab[idx] where idx is 1-D row indices into tab's leading axis —
    as a one-hot einsum over the (small) leading axis when the row count
    is small and many rows are selected (as flat_lookup)."""
    Kn = tab.shape[0]
    if idx.shape[0] * Kn < (1 << 12) or Kn > 256:
        return tab[idx]
    oh = (idx[:, None] == jnp.arange(Kn, dtype=idx.dtype)).astype(jnp.float32)
    flat = tab.reshape(Kn, -1).astype(jnp.float32)
    out = jnp.einsum('vk,kx->vx', oh, flat,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape((idx.shape[0],) + tab.shape[1:]).astype(tab.dtype)


def flat_lookup_multi(tabs2d, lin):
    """tabs2d[lin, :] for a [n, T] stack of T tables sharing one index
    array — one one-hot dot for all T tables (vs T separate lookups)."""
    n, T = tabs2d.shape
    if _nelem(lin) < _MIN_IDX or n > _MAX_TAB:
        return tabs2d[lin]
    oh = (lin[..., None] == jnp.arange(n, dtype=lin.dtype)
          ).astype(jnp.float32)
    out = jnp.einsum('...n,nt->...t', oh, tabs2d.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(tabs2d.dtype)


def row_col_lookup(tab2d, row, col):
    """tab2d[row, col] for a [Rows, C] table with C small (< ~32).

    Large index sets run as a row-select one-hot matmul (MXU) followed
    by a C-wide one-hot contraction — exact for integer values
    |v| < 2^24 (selection multiplies by exactly 0.0/1.0 under HIGHEST
    precision).  Small index sets use the plain gather."""
    Rn, Cn = tab2d.shape
    if _nelem(row) < _MIN_IDX or Rn > 2048:
        return tab2d[row, col]
    ohr = (row[..., None] == jnp.arange(Rn, dtype=row.dtype)
           ).astype(jnp.float32)
    rows = jnp.einsum('...r,rc->...c', ohr, tab2d.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
    ohc = (col[..., None] == jnp.arange(Cn, dtype=col.dtype)
           ).astype(jnp.float32)
    out = jnp.einsum('...c,...c->...', rows, ohc,
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(tab2d.dtype)

