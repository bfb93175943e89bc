"""Batched JAX evaluator for the integer Turner-2004 model.

Evaluates whole pair tables in one `lax.scan` over positions with an
explicit loop-frame stack (depth <= N/2+1), vmappable over any batch of
(codes, pair-table) pairs.  All arithmetic is int32 dekacal — bit-equal
to the CPU oracle (eval_np) by construction; a property test asserts
equality over the reference corpus.

Special hairpins (tetra/tri/hexa loops) use dense base-5-keyed lookup
arrays so the string matching of the reference oracle becomes a gather.

Design notes: the scan is sequential in N but all per-step work is
O(1) gathers/selects, so throughput comes from vmapping thousands of
candidate structures across the device's lanes; tables are small int32
arrays resident in device memory.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from rafft_tpu.energy.params import EnergyParams, get_params
from rafft_tpu.energy import _turner2004 as T
from rafft_tpu.engine.lookup import (flat_lookup, table_lookup,
                                     row_col_lookup, flat_lookup_multi)

INT_MISS = np.int32(np.iinfo(np.int32).min)


def _special_items(table: dict):
    """dict of k-mer string -> energy as [(base-5 key, value)] pairs."""
    code = {c: i for i, c in enumerate("NACGU")}
    out = []
    for st, v in table.items():
        key = 0
        for ch in st:
            key = key * 5 + code[ch]
        out.append((key, int(v)))
    return sorted(out)


def _dense_special(table: dict, k: int) -> np.ndarray:
    """dict of k-mer string -> energy  =>  dense base-5 keyed array."""
    arr = np.full(5 ** k, INT_MISS, dtype=np.int32)
    code = {c: i for i, c in enumerate("NACGU")}
    for s, v in table.items():
        key = 0
        for ch in s:
            key = key * 5 + code[ch]
        arr[key] = v
    return arr


class DeviceParams:
    """Energy tables packed for device-side evaluation."""

    def __init__(self, p: EnergyParams, max_len: int):
        L = max_len + 2
        self.pair_type = jnp.asarray(T.PAIR_TYPE, dtype=jnp.int32)
        self.stack = jnp.asarray(p.stack, dtype=jnp.int32)
        self.hairpin = jnp.asarray(p.hairpin_ext[:L], dtype=jnp.int32)
        self.bulge = jnp.asarray(p.bulge_ext[:L], dtype=jnp.int32)
        self.internal = jnp.asarray(p.internal_ext[:L], dtype=jnp.int32)
        self.mmh = jnp.asarray(p.mismatch_h, dtype=jnp.int32)
        self.mmi = jnp.asarray(p.mismatch_i, dtype=jnp.int32)
        self.mm1n = jnp.asarray(p.mismatch_1n, dtype=jnp.int32)
        self.mm23 = jnp.asarray(p.mismatch_23, dtype=jnp.int32)
        self.mmm = jnp.asarray(p.mismatch_m, dtype=jnp.int32)
        self.mmext = jnp.asarray(p.mismatch_ext, dtype=jnp.int32)
        self.d5 = jnp.asarray(p.dangle5, dtype=jnp.int32)
        self.d3 = jnp.asarray(p.dangle3, dtype=jnp.int32)
        self.int11 = jnp.asarray(p.int11, dtype=jnp.int32)
        self.int21 = jnp.asarray(p.int21, dtype=jnp.int32)
        self.int22 = jnp.asarray(p.int22, dtype=jnp.int32)
        # combined small-internal-loop table: the mutually-exclusive
        # int11/int21/int22 cases share ONE lookup (one gather where the
        # lookup helpers pick gathers, tools/microbench_medtab.py)
        # from a concatenated table (slot 0 = sentinel for other cases)
        self.small_loop = jnp.concatenate([
            jnp.zeros(1, jnp.int32),
            self.int11.reshape(-1),
            self.int21.reshape(-1),
            self.int22.reshape(-1),
        ])
        # same table factored [row, col<25]: the last two base-5 digits
        # of each case's index are the column, so a large-index lookup
        # becomes one [*,1985]@[1985,25] one-hot matmul (MXU) plus a
        # 25-wide contraction instead of the pathological gather
        # (row 0 = sentinel for non-small cases)
        self.small2d = jnp.concatenate([
            jnp.zeros((1, 25), jnp.int32),
            self.int11.reshape(64, 25),
            self.int21.reshape(320, 25),
            self.int22.reshape(1600, 25),
        ], axis=0)
        # the three internal-loop mismatch tables share index (t, a, b):
        # stacked so one one-hot dot serves all three (mm1n, mm23, mmi)
        self.mm3 = jnp.stack([
            self.mm1n.reshape(-1), self.mm23.reshape(-1),
            self.mmi.reshape(-1)], axis=-1)
        self.tetra = jnp.asarray(_dense_special(p.tetraloops, 6))
        self.tri = jnp.asarray(_dense_special(p.triloops, 5))
        self.hexa = jnp.asarray(_dense_special(p.hexaloops, 8))
        # sparse (key, value) views for large-index select chains — the
        # special-loop dicts have only ~2-30 entries each
        self.tri_items = _special_items(p.triloops)
        self.tetra_items = _special_items(p.tetraloops)
        self.hexa_items = _special_items(p.hexaloops)
        self.terminal_au = jnp.int32(p.terminal_au)
        self.ml_closing = jnp.int32(p.ml_closing)
        self.ml_intern = jnp.int32(p.ml_intern)
        self.ml_base = jnp.int32(p.ml_base)
        self.ninio_m = jnp.int32(p.ninio_m)
        self.ninio_max = jnp.int32(p.ninio_max)


_DP_CACHE: dict = {}


def device_params(temperature: float = 37.0, max_len: int = 4096) -> DeviceParams:
    key = (temperature, max_len)
    if key not in _DP_CACHE:
        _DP_CACHE[key] = DeviceParams(get_params(temperature), max_len)
    return _DP_CACHE[key]


def _g(table, *idx):
    """Multi-index table lookup through engine/lookup.py's formulation
    choice (one-hot einsum for small-table/large-index, flat gather
    otherwise)."""
    assert len(idx) == len(table.shape)
    return table_lookup(table, *idx)


def _ptype(dp, a, b):
    t = _g(dp.pair_type, a, b)
    return jnp.where(t == 0, 7, t)


def _sget(codes, i, n):
    """codes[i] with 0 (N) outside [0, n)."""
    ok = (i >= 0) & (i < n)
    return jnp.where(
        ok, flat_lookup(codes, jnp.clip(i, 0, codes.shape[0] - 1)), 0)


def _kmer_keys(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """key[i] = base-5 encoding of codes[i:i+k] (0-padded past the end)."""
    N = codes.shape[0]
    key = jnp.zeros(N, dtype=jnp.int32)
    for t in range(k):
        sh = jnp.concatenate([codes[t:], jnp.zeros(t, dtype=codes.dtype)])
        key = key * 5 + sh.astype(jnp.int32)
    return key


def _hairpin_v(dp, t, si1, sj1, size, k5, k6, k8, use_chain):
    """Hairpin energy from pre-gathered values.

    t = pair type of (i, j); si1/sj1 = codes[i+1]/codes[j-1];
    k5/k6/k8 = k-mer keys at i.  use_chain selects the sparse select
    chain for the special-loop tables (right for large index sets)."""
    e = flat_lookup(dp.hairpin, jnp.clip(size, 0, dp.hairpin.shape[0] - 1))
    mism = _g(dp.mmh, t, si1, sj1)

    if use_chain and hasattr(dp, "tri_items"):
        # large index sets: ~2-30 real entries per table, so a select
        # chain beats gathering from the 5^k dense arrays by ~10x
        def chain(items, key):
            out = jnp.full(key.shape, INT_MISS, dtype=jnp.int32)
            for kk, vv in items:
                out = jnp.where(key == kk, jnp.int32(vv), out)
            return out
        tri_e = chain(dp.tri_items, k5)
        tet_e = chain(dp.tetra_items, k6)
        hex_e = chain(dp.hexa_items, k8)
    else:
        tri_e = flat_lookup(dp.tri, jnp.clip(k5, 0, dp.tri.shape[0] - 1))
        tet_e = flat_lookup(dp.tetra, jnp.clip(k6, 0, dp.tetra.shape[0] - 1))
        hex_e = flat_lookup(dp.hexa, jnp.clip(k8, 0, dp.hexa.shape[0] - 1))

    generic = e + mism
    tri_out = jnp.where(tri_e != INT_MISS, tri_e,
                        e + jnp.where(t > 2, dp.terminal_au, 0))
    tet_out = jnp.where(tet_e != INT_MISS, tet_e, generic)
    hex_out = jnp.where(hex_e != INT_MISS, hex_e, generic)

    return jnp.where(size == 3, tri_out,
                     jnp.where(size == 4, tet_out,
                               jnp.where(size == 6, hex_out, generic)))


def _hairpin(dp, codes, n, i, j, key5, key6, key8):
    size = j - i - 1
    t = _ptype(dp, _sget(codes, i, n), _sget(codes, j, n))
    k5 = flat_lookup(key5, i)
    k6 = flat_lookup(key6, i)
    k8 = flat_lookup(key8, i)
    n_idx = int(np.prod(k5.shape)) if k5.shape else 1
    from rafft_tpu.engine import lookup as _lk
    use_chain = (n_idx >= (1 << 14)) or _lk._ASSUME_BATCHED
    return _hairpin_v(dp, t, _sget(codes, i + 1, n), _sget(codes, j - 1, n),
                      size, k5, k6, k8, use_chain)


def _int_loop_v(dp, t1, t2, si1, sj1, sp1, sq1, n1, n2):
    """Two-loop energy from pre-gathered values.

    t1 = type of closing pair (i, j); t2 = type of inner pair seen from
    inside, i.e. _ptype(codes[r], codes[q]); si1/sj1 = codes[i+1] /
    codes[j-1]; sp1/sq1 = codes[q-1]/codes[r+1]; n1/n2 = unpaired runs
    q-i-1 / j-r-1."""
    nl = jnp.maximum(n1, n2)
    ns = jnp.minimum(n1, n2)

    stack_e = _g(dp.stack, t1, t2)

    blg = flat_lookup(dp.bulge, jnp.clip(nl, 0, dp.bulge.shape[0] - 1))
    bulge_e = blg + jnp.where(
        nl == 1, stack_e,
        jnp.where(t1 > 2, dp.terminal_au, 0) + jnp.where(t2 > 2, dp.terminal_au, 0))

    # int11/int21/int22 are mutually exclusive by (ns, nl): one combined
    # lookup from the row/column-factored table (dp.small2d) — the last
    # two base-5 digits of each case's index form the column, so the
    # lookup runs as a row-select matmul + 25-wide contraction instead
    # of a computed-index gather (tools/microbench_medtab.py)
    sel11 = (ns == 1) & (nl == 1)
    sel21 = (ns == 1) & (nl == 2)
    sel22 = (ns == 2) & (nl == 2)
    # int21 orientation: bulge-of-1 on the 5' side keys (t1,t2,si1,sq1,sj1),
    # otherwise the reversed frame (t2,t1,sq1,si1,sp1)
    fwd21 = n1 == 1
    a1 = jnp.where(fwd21, t1, t2)
    b1 = jnp.where(fwd21, t2, t1)
    c1 = jnp.where(fwd21, si1, sq1)
    d1 = jnp.where(fwd21, sq1, si1)
    e1 = jnp.where(fwd21, sj1, sp1)
    row = jnp.where(
        sel11, 1 + (t1 * 8 + t2),
        jnp.where(
            sel21, 65 + (a1 * 8 + b1) * 5 + c1,
            jnp.where(
                sel22, 385 + ((t1 * 8 + t2) * 5 + si1) * 5 + sp1, 0)))
    col = jnp.where(
        sel11, si1 * 5 + sj1,
        jnp.where(sel21, d1 * 5 + e1,
                  jnp.where(sel22, sq1 * 5 + sj1, 0)))
    small = row_col_lookup(dp.small2d, row, col)

    ninio = jnp.minimum(dp.ninio_max, (nl - ns) * dp.ninio_m)
    mmA = flat_lookup_multi(dp.mm3, (t1 * 5 + si1) * 5 + sj1)
    mmB = flat_lookup_multi(dp.mm3, (t2 * 5 + sq1) * 5 + sp1)
    onexn = (flat_lookup(dp.internal, jnp.clip(nl + 1, 0, dp.internal.shape[0] - 1))
             + ninio + mmA[..., 0] + mmB[..., 0])

    l23 = dp.internal[5] + dp.ninio_m + mmA[..., 1] + mmB[..., 1]

    generic = (flat_lookup(dp.internal, jnp.clip(nl + ns, 0, dp.internal.shape[0] - 1))
               + ninio + mmA[..., 2] + mmB[..., 2])

    ns1 = jnp.where(nl <= 2, small, onexn)
    ns2 = jnp.where(nl == 2, small, jnp.where(nl == 3, l23, generic))
    inner = jnp.where(ns == 1, ns1, jnp.where(ns == 2, ns2, generic))

    return jnp.where(nl == 0, stack_e, jnp.where(ns == 0, bulge_e, inner))


def _int_loop(dp, codes, n, i, j, q, r):
    """Two-loop closed by (i,j) with inner pair (q,r)."""
    t1 = _ptype(dp, _sget(codes, i, n), _sget(codes, j, n))
    t2 = _ptype(dp, _sget(codes, r, n), _sget(codes, q, n))
    return _int_loop_v(dp, t1, t2,
                       _sget(codes, i + 1, n), _sget(codes, j - 1, n),
                       _sget(codes, q - 1, n), _sget(codes, r + 1, n),
                       q - i - 1, j - r - 1)


def _ml_stem(dp, t, s5, s3):
    return (_g(dp.mmm, t, s5, s3) + jnp.where(t > 2, dp.terminal_au, 0)
            + dp.ml_intern)


def _ext_stem_v(dp, t, s5, s3, has5, has3):
    """Exterior stem term from pre-gathered values (t = type of (i,j),
    s5/s3 = codes[i-1]/codes[j+1], has5/has3 = neighbour-exists masks)."""
    e = jnp.where(
        has5 & has3, _g(dp.mmext, t, s5, s3),
        jnp.where(has5, _g(dp.d5, t, s5), jnp.where(has3, _g(dp.d3, t, s3), 0)))
    return e + jnp.where(t > 2, dp.terminal_au, 0)


def _ext_stem(dp, codes, n, i, j):
    t = _ptype(dp, _sget(codes, i, n), _sget(codes, j, n))
    return _ext_stem_v(dp, t, _sget(codes, i - 1, n), _sget(codes, j + 1, n),
                       i > 0, j < n - 1)


def eval_pt(dp: DeviceParams, codes: jnp.ndarray, pt: jnp.ndarray,
            n: jnp.ndarray) -> jnp.ndarray:
    """Integer energy of one pair table — fully parallel formulation.

    No sequential scan: the innermost enclosing pair of every opening is
    found with a masked max-reduction (nesting means p < i and
    pt[p] > i suffices), children statistics per loop come from masked
    reductions over the [N, N] parent-incidence relation (MXU/VPU
    friendly), and every loop's energy is then a parallel gather.
    """
    N = codes.shape[0]
    key5 = _kmer_keys(codes, 5)
    key6 = _kmer_keys(codes, 6)
    key8 = _kmer_keys(codes, 8)

    ii = jnp.arange(N, dtype=jnp.int32)
    valid = ii < n
    is_open = valid & (pt > ii)

    # parent opening of each opening i: max p < i with pt[p] > i (else -1).
    # Single fused masked max-reduction — everything downstream is
    # masked-reduction arithmetic over the same [N, N] relation (no
    # segment_sum/argsort: no scatters or computed-index sorts, the
    # formulation engine/lookup.py prefers).
    enc = (ii[None, :] < ii[:, None]) & is_open[None, :] & (pt[None, :] > ii[:, None])
    parent = jnp.max(jnp.where(enc, ii[None, :], -1), axis=1)  # [N]

    t_stem = _ptype(dp, codes, flat_lookup(codes, jnp.clip(pt, 0, N - 1)))
    s5 = _sget_vec(codes, ii - 1, n)
    s3 = _sget_vec(codes, jnp.clip(pt, 0, N - 1) + 1, n)
    mls = _ml_stem(dp, t_stem, s5, s3)                                # [N]

    # ---- compact openings to H = N/2+1 slots: loop energies are only
    # needed per pair, so the expensive table gathers run on half the
    # lanes.  op[h] = position of the h-th opening (N-filled) via a
    # rank one-hot reduction.
    H = N // 2 + 1
    rank = jnp.cumsum(is_open.astype(jnp.int32)) - 1
    hh = jnp.arange(H, dtype=jnp.int32)
    ohp = is_open[None, :] & (rank[None, :] == hh[:, None])        # [H,N]
    op = jnp.where(ohp.any(axis=1),
                   jnp.max(jnp.where(ohp, ii[None, :], 0), axis=1),
                   N + hh)
    op_valid = op < N
    opc = jnp.clip(op, 0, N - 1)
    i_o = jnp.where(op_valid, op, 0)
    j_o = jnp.clip(jnp.where(op_valid, flat_lookup(pt, opc), 0), 0, N - 1)

    # children stats per compacted opening: child i contributes to slot h
    # iff parent[i] == op[h] (exterior handled separately)
    chm = (is_open[None, :]
           & (parent[None, :] == jnp.where(op_valid, op, -7)[:, None]))
    branches = chm.sum(axis=1).astype(jnp.int32)
    first_child = jnp.min(jnp.where(chm, ii[None, :], N), axis=1)
    mlsum = jnp.where(chm, mls[None, :], 0).sum(axis=1)
    q = jnp.clip(first_child, 0, N - 1)
    r = jnp.clip(flat_lookup(pt, q), 0, N - 1)

    hp = _hairpin(dp, codes, n, i_o, j_o, key5, key6, key8)
    il = _int_loop(dp, codes, n, i_o, j_o, q, r)
    tc = _ptype(dp, _sget_vec(codes, j_o, n), _sget_vec(codes, i_o, n))
    ml = (dp.ml_closing + mlsum
          + _ml_stem(dp, tc, _sget_vec(codes, j_o - 1, n),
                     _sget_vec(codes, i_o + 1, n)))
    loop_e = jnp.where(branches == 0, hp,
                       jnp.where(branches == 1, il, ml))

    ext = _ext_stem(dp, codes, n, i_o, j_o)

    total = jnp.sum(jnp.where(op_valid, loop_e, 0))
    total += jnp.sum(jnp.where(
        op_valid & (flat_lookup(parent, opc) == -1), ext, 0))
    return total.astype(jnp.int32)


def _sget_vec(codes, idx, n):
    ok = (idx >= 0) & (idx < n)
    return jnp.where(
        ok, flat_lookup(codes, jnp.clip(idx, 0, codes.shape[0] - 1)), 0)


def analyze_pt(dp: DeviceParams, codes: jnp.ndarray, pt: jnp.ndarray,
               n: jnp.ndarray):
    """Loop analysis of one pair table for the fold engine.

    Returns a dict of [N]-arrays:
      enclose   innermost enclosing opening of every position (-1 = exterior)
      is_open   opening mask
      branches / first_child / mlsum / loop_e   per-opening loop caches
      energy    total integer energy
    loop_e[p] is the energy of the loop closed by pair (p, pt[p]); the
    total also includes exterior stem terms (not attributed to a loop).
    """
    N = codes.shape[0]
    key5 = _kmer_keys(codes, 5)
    key6 = _kmer_keys(codes, 6)
    key8 = _kmer_keys(codes, 8)

    HI = jax.lax.Precision.HIGHEST
    ii = jnp.arange(N, dtype=jnp.int32)
    valid = ii < n
    is_open = valid & (pt > ii)

    enc = (ii[None, :] < ii[:, None]) & is_open[None, :] & (pt[None, :] > ii[:, None])
    enclose = jnp.max(jnp.where(enc, ii[None, :], -1), axis=1)

    t_stem = _ptype(dp, codes, flat_lookup(codes, jnp.clip(pt, 0, N - 1)))
    s5v = _sget_vec(codes, ii - 1, n)
    s3v = _sget_vec(codes, jnp.clip(pt, 0, N - 1) + 1, n)
    mls = _ml_stem(dp, t_stem, s5v, s3v)

    # ---- compact openings to H = N/2+1 lanes (same trick as eval_pt):
    # the expensive loop-energy gathers (hairpin k-mer chains, two-loop
    # small2d) and the child-of relation then run on half the lanes;
    # per-position caches scatter back through the same one-hot.
    H = N // 2 + 1
    rank = jnp.cumsum(is_open.astype(jnp.int32)) - 1
    hh = jnp.arange(H, dtype=jnp.int32)
    ohp = is_open[None, :] & (rank[None, :] == hh[:, None])        # [H,N]
    ohpf = ohp.astype(jnp.float32)
    op_valid = ohp.any(axis=1)
    op = jnp.where(op_valid,
                   jnp.max(jnp.where(ohp, ii[None, :], 0), axis=1), N + hh)

    # children stats per compacted opening over the [H, N] relation
    chm = (is_open[None, :]
           & (enclose[None, :] == jnp.where(op_valid, op, -7)[:, None]))
    branches_h = chm.sum(axis=1).astype(jnp.int32)
    first_child_h = jnp.min(jnp.where(chm, ii[None, :], N), axis=1)
    mlsum_h = jnp.where(chm, mls[None, :], 0).sum(axis=1)

    i_o = jnp.where(op_valid, op, 0)
    opc = jnp.clip(op, 0, N - 1)
    j_o = jnp.clip(jnp.where(op_valid, flat_lookup(pt, opc), 0), 0, N - 1)
    q = jnp.clip(first_child_h, 0, N - 1)
    r = jnp.clip(flat_lookup(pt, q), 0, N - 1)
    hp = _hairpin(dp, codes, n, i_o, j_o, key5, key6, key8)
    il = _int_loop(dp, codes, n, i_o, j_o, q, r)
    tc = _ptype(dp, _sget_vec(codes, j_o, n), _sget_vec(codes, i_o, n))
    ml = (dp.ml_closing + mlsum_h
          + _ml_stem(dp, tc, _sget_vec(codes, j_o - 1, n),
                     _sget_vec(codes, i_o + 1, n)))
    loop_e_h = jnp.where(branches_h == 0, hp,
                         jnp.where(branches_h == 1, il, ml))
    loop_e_h = jnp.where(op_valid, loop_e_h, 0)
    ext_h = _ext_stem(dp, codes, n, i_o, j_o)

    def scat(xh, fill=0):
        """[H] per-opening values -> [N] at the opening positions."""
        out = jnp.einsum('hn,h->n', ohpf, xh.astype(jnp.float32),
                         precision=HI).astype(jnp.int32)
        return jnp.where(is_open, out, fill)

    branches = scat(branches_h)
    first_child = scat(first_child_h, N)
    mlsum = scat(mlsum_h)
    loop_e = scat(loop_e_h)
    ext = scat(ext_h)
    energy = (jnp.sum(loop_e_h)
              + jnp.sum(jnp.where(
                  op_valid & (flat_lookup(enclose, opc) == -1), ext_h, 0))
              ).astype(jnp.int32)

    return dict(enclose=enclose, is_open=is_open, branches=branches,
                first_child=first_child, mlsum=mlsum, loop_e=loop_e,
                mls=jnp.where(is_open, mls, 0),
                exts=ext, energy=energy)


def eval_pt_scan(dp: DeviceParams, codes: jnp.ndarray, pt: jnp.ndarray,
                 n: jnp.ndarray) -> jnp.ndarray:
    """Sequential-scan evaluator (kept as an O(N)-memory fallback for very
    long sequences where the [N, N] relation would not fit)."""
    N = codes.shape[0]
    D = N // 2 + 2
    key5 = _kmer_keys(codes, 5)
    key6 = _kmer_keys(codes, 6)
    key8 = _kmer_keys(codes, 8)

    # frame stacks
    init = dict(
        depth=jnp.int32(0),
        energy=jnp.int32(0),
        f_open=jnp.zeros(D, dtype=jnp.int32),
        f_branches=jnp.zeros(D, dtype=jnp.int32),
        f_mlsum=jnp.zeros(D, dtype=jnp.int32),
        f_q=jnp.zeros(D, dtype=jnp.int32),
        f_r=jnp.zeros(D, dtype=jnp.int32),
    )

    def step(st, k):
        j = pt[k]
        valid = k < n
        is_open = valid & (j > k)
        is_close = valid & (j >= 0) & (j < k)

        d = st["depth"]
        nd = jnp.clip(d + 1, 0, D - 1)
        pd = jnp.clip(d - 1, 0, D - 1)

        # ---- close-path quantities (computed unconditionally, masked in)
        i = jnp.where(is_close, j, 0)
        b = st["f_branches"][d]
        hp = _hairpin(dp, codes, n, i, k, key5, key6, key8)
        il = _int_loop(dp, codes, n, i, k, st["f_q"][d], st["f_r"][d])
        tc = _ptype(dp, _sget(codes, k, n), _sget(codes, i, n))
        ml = (dp.ml_closing + st["f_mlsum"][d]
              + _ml_stem(dp, tc, _sget(codes, k - 1, n), _sget(codes, i + 1, n)))
        loop_e = jnp.where(b == 0, hp, jnp.where(b == 1, il, ml))

        tstem = _ptype(dp, _sget(codes, i, n), _sget(codes, k, n))
        mls = _ml_stem(dp, tstem, _sget(codes, i - 1, n), _sget(codes, k + 1, n))
        ext = _ext_stem(dp, codes, n, i, k)
        at_top = pd == 0

        # ---- branch-free state update
        st = dict(st)
        st["energy"] = st["energy"] + jnp.where(
            is_close, loop_e + jnp.where(at_top, ext, 0), 0)

        # push: reset frame nd; only when opening
        st["f_open"] = st["f_open"].at[nd].set(
            jnp.where(is_open, k, st["f_open"][nd]))
        st["f_branches"] = st["f_branches"].at[nd].set(
            jnp.where(is_open, 0, st["f_branches"][nd]))
        st["f_mlsum"] = st["f_mlsum"].at[nd].set(
            jnp.where(is_open, 0, st["f_mlsum"][nd]))

        # pop: fold this stem into the parent frame; only when closing
        pb = st["f_branches"][pd]
        st["f_q"] = st["f_q"].at[pd].set(
            jnp.where(is_close & (pb == 0), i, st["f_q"][pd]))
        st["f_r"] = st["f_r"].at[pd].set(
            jnp.where(is_close & (pb == 0), k, st["f_r"][pd]))
        st["f_branches"] = st["f_branches"].at[pd].set(
            jnp.where(is_close, pb + 1, pb))
        st["f_mlsum"] = st["f_mlsum"].at[pd].add(jnp.where(is_close, mls, 0))

        st["depth"] = jnp.where(is_open, nd, jnp.where(is_close, pd, d))
        return st, None

    st, _ = jax.lax.scan(step, init, jnp.arange(N, dtype=jnp.int32))
    return st["energy"]


@jax.jit
def _eval_batch_jit(codes, pt, n, dp_dict):
    from types import SimpleNamespace

    dp = SimpleNamespace(**dp_dict)
    return jax.vmap(lambda c, p, ln: eval_pt(dp, c, p, ln))(codes, pt, n)


def eval_batch(codes: np.ndarray, pt: np.ndarray, n: np.ndarray,
               temperature: float = 37.0) -> np.ndarray:
    """Convenience host API: batch-evaluate [B, N] codes/pair-tables."""
    N = codes.shape[-1]
    dp = device_params(temperature, max_len=N)
    return np.asarray(_eval_batch_jit(
        jnp.asarray(codes, dtype=jnp.int32), jnp.asarray(pt, dtype=jnp.int32),
        jnp.asarray(n, dtype=jnp.int32), dict(dp.__dict__)))
