"""Minimum-free-energy (Zuker) folding under the framework's Turner model.

Native replacement for the reference's ViennaRNA `RNA.fold` baseline
(/root/reference/benchmark_results/src/vrna_mfe.py:24): the MFE
structure + energy used as the benchmark comparator and by the analysis
utilities.  Two backends share the calibrated parameter tables:

* `mfe_fold` — native C++ Zuker DP (rafft_tpu/native/turner_eval.cpp),
  exact integer dekacal arithmetic, O(N^2) memory / O(N^3) time.
* `rafft_tpu.mfe.mfe_jax.mfe_batch` — batched fixed-shape JAX DP for
  device sweeps (anti-diagonal `lax.scan`), validated against the C++
  backend.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rafft_tpu.energy.params import encode_sequence
from rafft_tpu.struct import dot_bracket

_MFE_READY = False


def _lib(temperature: float):
    global _MFE_READY
    from rafft_tpu import native as N

    lib = N._load()
    if lib is None:
        raise RuntimeError("native turner library unavailable")
    if not _MFE_READY:
        lib.turner_mfe.restype = ctypes.c_int32
        lib.turner_mfe.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        _MFE_READY = True
    N._init_tables(lib, temperature)
    return lib


def mfe_fold_pt(seq: str, temperature: float = 37.0):
    """(pair_table, energy_int_dekacal) of the MFE structure."""
    lib = _lib(temperature)
    codes = encode_sequence(seq).astype(np.int8)
    n = len(codes)
    pt = np.empty(n, dtype=np.int32)
    e = lib.turner_mfe(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int32(n),
        pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return pt, int(e)


def mfe_fold(seq: str, temperature: float = 37.0):
    """(dot_bracket, energy_kcal_per_mol) — the `RNA.fold` surface."""
    pt, e = mfe_fold_pt(seq, temperature)
    pairs = [(i, int(j)) for i, j in enumerate(pt) if j > i]
    return dot_bracket(pairs, len(pt)), e / 100.0
