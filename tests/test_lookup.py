"""Exactness tests for the one-hot lookup formulations.

The one-hot einsum path must reproduce gathers bit-for-bit; the original
bug this guards against: default-precision f32 dots round operands
through bf16, turning 751 into 752 (engine/lookup.py)."""

import numpy as np
import jax.numpy as jnp

from rafft_tpu.engine.lookup import flat_lookup, batched_taa, _MIN_IDX


def test_flat_lookup_exact_large_values():
    rng = np.random.default_rng(7)
    tab = rng.integers(-(1 << 23), 1 << 23, 257, dtype=np.int32)
    # 751-style values that don't fit in 8 mantissa bits
    tab[:8] = [751, -751, 1090, -1090, 833, -833, 12345, -99999]
    idx = rng.integers(0, 257, 4 * _MIN_IDX, dtype=np.int32)
    got = np.asarray(flat_lookup(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, tab[idx])


def test_batched_taa_exact():
    rng = np.random.default_rng(8)
    K, R, X, M = 16, 8, 130, 160   # K*R*M >= _MIN_IDX
    tab = rng.integers(-(1 << 23), 1 << 23, (K, R, X), dtype=np.int32)
    idx = rng.integers(0, X, (K, R, M), dtype=np.int32)
    got = np.asarray(batched_taa(jnp.asarray(tab), jnp.asarray(idx)))
    want = np.take_along_axis(tab, idx, axis=-1)
    np.testing.assert_array_equal(got, want)

