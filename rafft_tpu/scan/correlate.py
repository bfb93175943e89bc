"""Cross-correlation between the forward and backward strand encodings.

cor[k] = sum_{i+j=k} pairweight(s[pos[i]], s[pos[j]]), normalised by the
triangle overlap count (+pad), exactly as the reference
(/root/reference/rafft/utils.py:115-132).  Peaks at lag k mark
complementary palindromic registers: positions i and k-i can stack.

Two paths:
  - correlate_np: scipy.signal.convolve per channel — including scipy's
    auto direct/FFT method switch, so float noise (and therefore
    tie-ordering of equal peaks) matches the reference bit-for-bit.
  - correlate_jax: batched real-FFT over padded regions for the device
    engine (energy decisions there are integer; correlation only ranks
    candidate lags, so f32 FFT noise does not affect correctness).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import convolve as _sp_convolve

from rafft_tpu.scan.encode import forward_onehot, backward_weights


def correlate_np(codes_region: np.ndarray, W: np.ndarray, pad: float = 1.0):
    """Normalised correlation of one region (codes at its positions).

    Returns float64 array of length 2m-1 (lag = i+j in region-local
    coordinates)."""
    m = codes_region.shape[0]
    fwd = forward_onehot(codes_region)
    bwd = backward_weights(codes_region, W)
    # the reference convolves fwd with the re-flipped backward strand
    bwd_unflipped = bwd[:, ::-1]
    cor = np.zeros(2 * m - 1, dtype=np.float64)
    acc = []
    for c in range(4):
        acc.append(_sp_convolve(fwd[c], bwd_unflipped[c]))
    cor = np.sum(np.array(acc), axis=0)
    norm = [(el + pad) for el in list(range(m)) + list(range(m - 1))[::-1]]
    return cor / norm


def top_lags(cor: np.ndarray, nb_mode: int):
    """Reference lag ranking: stable ascending sort by value, then
    reversed — i.e. descending value, ties broken by descending lag
    (/root/reference/rafft/rafft.py:117-118,95)."""
    cor_l = [[i, c] for i, c in enumerate(cor)]
    cor_l.sort(key=lambda el: el[1])
    return [(int(i), c) for i, c in cor_l[::-1][:nb_mode]]


# ---------------------------------------------------------------- JAX path
def correlate_jax(fwd, bwd, lengths, pad: float = 1.0):
    """Batched correlation on the device.

    fwd: [B, 4, M] one-hot (padded), bwd: [B, 4, M] weights (padded,
    reversed *within the true length*), lengths: [B] true region sizes.
    Returns [B, 2M-1] normalised correlation with -inf outside the valid
    2*len-1 lag range.
    """
    import jax.numpy as jnp

    B, _, M = fwd.shape
    L = 2 * M  # FFT length covering full linear convolution
    f = jnp.fft.rfft(fwd, n=L, axis=-1)
    # un-flip within true length: bwd comes reversed over the padded axis?
    # callers supply bwd already in forward (unflipped) orientation.
    g = jnp.fft.rfft(bwd, n=L, axis=-1)
    conv = jnp.fft.irfft(f * g, n=L, axis=-1)[:, :, : 2 * M - 1]
    cor = conv.sum(axis=1)
    lag = jnp.arange(2 * M - 1)[None, :]
    m = lengths[:, None]
    tri = jnp.minimum(lag, m - 1) - jnp.maximum(lag - (m - 1), 0) + 1  # overlap count
    norm = jnp.where(lag < 2 * m - 1, jnp.minimum(lag, 2 * m - 2 - lag) + pad, 1.0)
    valid = lag < 2 * m - 1
    return jnp.where(valid, cor / norm, -jnp.inf)
