"""Anti-diagonal wavefront window scan: a Pallas kernel for the GPU.

RAFFT's stem search slides a window along every correlation lag of a
region.  The cells a slide visits are the cells (ip, jp) of the
region-local pair matrix, cell (ip, jp) belongs to lag ip + jp, and the
recurrence of one lag depends only on that lag's previous cell
(ip - 1, jp + 1).  A sweep over rows ip therefore advances every lag at
once.  The state is indexed by lag, so it never moves: on row ip, lag L
reads its 3' base at jp = L - ip, a contiguous slice of the region row
at offset -ip, and its 5' base at ip, one scalar shared by all lags.
The values read on the previous row are the (ip - 1, jp + 1) neighbours
the recurrence needs, so they ride along as carries.

The correlation comes free.  The pair-weight matrix is symmetric, so a
lag's full anti-diagonal sum is twice its window's sum less the centre
cell.  For integral weights that is an exact small-integer sum in f32,
equal to the rounded FFT correlation of fold_jax._correlate.

The kernel runs on the Triton route.  One program owns one (region,
block of BL lags) pair, keeps its state in registers and loops only over
the rows its lags' windows cover; empty and one-base regions exit at
once.  Off the GPU the engine keeps the FFT + window scan, and the tests
run this kernel through the Pallas interpreter.

Semantics equal fold_jax._window_scan on every lag it consumes: the
same f32 and int32 operations in the same order per lag.  There is no
matrix product anywhere, so TF32 cannot arise.  `tests/test_wavefront.py`
asserts equality against that formulation.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# lags per kernel program: one f32/int32 lane per thread at 4 warps
BL = 128


def supported(cfg, integral: bool) -> bool:
    """Shape limits of the lag-indexed wavefront.

    Lag blocks are BL wide, so 2N must hold whole blocks and the region
    row padding (N on each side) must cover a block's reach: N a power
    of two and at least BL.  Non-integral pair weights sum differently
    from the FFT correlation they must match, so they keep the FFT
    path."""
    N = cfg.N
    return integral and N >= BL and (N & (N - 1)) == 0


def _select(lin, table, default, dtype):
    """table[lin] as a chain of selects over the table's nonzero
    entries (host constants)."""
    out = jnp.full(jnp.shape(lin), default, dtype)
    for v, x in enumerate(np.asarray(table).reshape(-1)):
        if x != 0:
            out = jnp.where(lin == v, dtype(x), out)
    return out


def _stack(A, Bt, ST):
    """ST[A, Bt] for pair types A, Bt in 1..6 (0 otherwise)."""
    g = jnp.zeros(jnp.shape(Bt), jnp.int32)
    for a in range(1, 7):
        ga = jnp.zeros(jnp.shape(Bt), jnp.int32)
        for b in range(1, 7):
            ga = jnp.where(Bt == b, jnp.int32(int(ST[a, b])), ga)
        g = jnp.where(A == a, ga, g)
    return g


def _lag_geometry(lag, m):
    """Window start row, window length and validity of each lag."""
    base = jnp.maximum(lag - m + 1, 0)
    width = jnp.where(lag < m, lag + 1, 2 * m - lag - 1)
    half = width // 2 + width % 2
    return base, half, lag < 2 * m - 1


_INT_FIELDS = ("tmp", "sE", "hd1", "hd2", "nb", "mi", "mj", "bsE", "bh1",
               "bh2", "pk3")
_F32_FIELDS = ("tot", "ms", "cor")


def _init_state(shape):
    st = {k: jnp.zeros(shape, jnp.int32) for k in _INT_FIELDS}
    st.update({k: jnp.zeros(shape, jnp.float32) for k in _F32_FIELDS})
    return st


def _row(st, ip, lag, base, half, valid, pk5, pk5m, z15, z25, pk3, z13,
         z23, *, min_hp, Wn, PTn, STn):
    """Advance every lag by row ip.

    pk* are packed (rpos << 3 | code) region entries: pk5 at ip, pk5m at
    ip - 1, pk3 at jp = lag - ip; st["pk3"] holds the previous row's pk3,
    i.e. the entry at jp + 1.  z1*/z2* are the hash coefficients Z[rpos]
    at ip (z*5) and jp (z*3).  Only cells inside a lag's window change
    its state, as in fold_jax._window_scan."""
    i = ip - base
    act = valid & (i >= 0) & (i < half)
    c5, p5 = pk5 & 7, pk5 >> 3
    c5m, p5m = pk5m & 7, pk5m >> 3
    c3, p3 = pk3 & 7, pk3 >> 3
    c3p, p3p = st["pk3"] & 7, st["pk3"] >> 3

    w = _select(c5 * 5 + c3, Wn, 0, jnp.float32)
    contig = (i > 0) & (p5 - p5m == 1) & (p3p - p3 == 1)
    tot_p = st["tot"]
    tot = jnp.where(contig, (tot_p + w) * w, w)
    tmp = jnp.where(tot == 0, 0, st["tmp"] + 1)
    # stack energy between the outer pair (ip-1, jp+1) and (ip, jp)
    g = _stack(_select(c5m * 5 + c3p, PTn, 7, jnp.int32),
               _select(c3 * 5 + c5, PTn, 7, jnp.int32), STn)
    in_run = (tot != 0) & (tot_p != 0) & contig
    sE = jnp.where((tot == 0) | (tot_p == 0), 0,
                   jnp.where(in_run, st["sE"] + g, st["sE"]))
    # hash delta of pairing (p5, p3): Z[p5]*(p3+1) + Z[p3]*(p5+1),
    # int32 wraparound == uint32 arithmetic mod 2^32
    hd1 = jnp.where(tot == 0, 0, st["hd1"] + (z15 * (p3 + 1) + z13 * (p5 + 1)))
    hd2 = jnp.where(tot == 0, 0, st["hd2"] + (z25 * (p3 + 1) + z23 * (p5 + 1)))
    upd = act & ((p3 - p5) > min_hp) & (tot >= st["ms"])

    def keep(new, old):
        return jnp.where(act, new, old)

    def best(new, old):
        return jnp.where(upd, new, old)

    return dict(
        tot=keep(tot, tot_p), tmp=keep(tmp, st["tmp"]),
        sE=keep(sE, st["sE"]), hd1=keep(hd1, st["hd1"]),
        hd2=keep(hd2, st["hd2"]),
        ms=best(tot, st["ms"]), nb=best(tmp, st["nb"]),
        mi=best(ip, st["mi"]), mj=best(lag - ip, st["mj"]),
        bsE=best(sE, st["bsE"]), bh1=best(hd1, st["bh1"]),
        bh2=best(hd2, st["bh2"]),
        cor=st["cor"] + jnp.where(act, jnp.where(2 * ip == lag, w, 2 * w),
                                  0.0),
        pk3=pk3)


_OUT = ("cor", "nb", "mi", "mj", "bsE", "bh1", "bh2")


def _kernel(m_ref, pk_ref, z1_ref, z2_ref, *out_refs, N, consts):
    """One program: region g = program_id(0), lags [l0, l0 + BL).

    Region rows are padded by N on each side, so every slice a block
    reads is in bounds and needs no mask."""
    m = m_ref[0]
    l0 = pl.program_id(1) * BL
    lag = l0 + jax.lax.broadcasted_iota(jnp.int32, (BL,), 0)
    base, half, valid = _lag_geometry(lag, m)
    # rows covered by the block's windows: from the first lag's window
    # start to the end of the last valid lag's window (monotone in lag)
    l_hi = jnp.minimum(l0 + BL - 1, 2 * m - 2)
    b_hi = jnp.maximum(l_hi - m + 1, 0)
    w_hi = jnp.where(l_hi < m, l_hi + 1, 2 * m - l_hi - 1)
    ip_lo = jnp.maximum(l0 - m + 1, 0)
    ip_hi = jnp.where((m >= 2) & (l0 <= l_hi),
                      b_hi + w_hi // 2 + w_hi % 2, ip_lo)

    def body(ip, carry):
        st, pk5m = carry
        pk5 = pk_ref[N + ip]
        off = N + l0 - ip
        st = _row(st, ip, lag, base, half, valid, pk5, pk5m,
                  z1_ref[N + ip], z2_ref[N + ip], pk_ref[pl.ds(off, BL)],
                  z1_ref[pl.ds(off, BL)], z2_ref[pl.ds(off, BL)], **consts)
        return st, pk5

    st, _ = jax.lax.fori_loop(ip_lo, ip_hi, body,
                              (_init_state((BL,)), jnp.int32(0)))
    for ref, key in zip(out_refs, _OUT):
        ref[...] = st[key]


def _consts(cfg, dp, W):
    return dict(min_hp=cfg.min_hp,
                Wn=np.asarray(W, np.float32).reshape(5, 5),
                PTn=np.asarray(dp.pair_type).reshape(5, 5),
                STn=np.asarray(dp.stack).reshape(8, 8))


def _tables_kernel(mlen, pk, z1, z2, *, N, consts, interpret):
    K, R = mlen.shape
    G, P = K * R, 3 * N
    row = pl.BlockSpec((None, P), lambda g, j: (g, 0))
    out = pl.BlockSpec((None, BL), lambda g, j: (g, j))
    outs = pl.pallas_call(
        partial(_kernel, N=N, consts=consts),
        grid=(G, 2 * N // BL),
        in_specs=[pl.BlockSpec((None, 1), lambda g, j: (g, 0)), row, row,
                  row],
        out_specs=[out] * len(_OUT),
        out_shape=[jax.ShapeDtypeStruct(
            (G, 2 * N), jnp.float32 if k in _F32_FIELDS else jnp.int32)
            for k in _OUT],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="wavefront",
    )(mlen.reshape(G, 1), pk.reshape(G, P), z1.reshape(G, P),
      z2.reshape(G, P))
    return [o.reshape(K, R, 2 * N) for o in outs]


def wavefront_tables(cfg, dp, W, rcodes, rpos, mlen, z1row, z2row,
                     interpret=False):
    """Per-lag window-scan tables, [K, R, 2N] each.

    Returns dict(cor_raw, max_nb, max_i, max_j, best_sE, hd1, hd2).
    cor_raw is the un-normalised correlation (the caller divides by the
    triangle+pad norm); hd1/hd2 are the candidate stems' pair-table hash
    deltas (uint32 bit patterns in int32), from the Z[rpos] coefficient
    tables z1row/z2row.  rcodes/rpos/mlen/z*row are one sequence's
    regions, [K, R, N] with rpos N-padded and rcodes 0-padded; vmap adds
    batch dimensions.

    interpret: run the kernel through the Pallas interpreter (CPU tests)
    instead of compiling it for the GPU."""
    N = cfg.N
    assert supported(cfg, True), N
    pad = ((0, 0), (0, 0), (N, N))
    pk = jnp.pad(rpos * 8 + rcodes, pad, constant_values=N * 8)
    z1 = jnp.pad(z1row, pad)
    z2 = jnp.pad(z2row, pad)
    consts = _consts(cfg, dp, W)
    mlen = mlen.astype(jnp.int32)
    cor, nb, mi, mj, sE, hd1, hd2 = _tables_kernel(
        mlen, pk, z1, z2, N=N, consts=consts, interpret=interpret)
    return dict(cor_raw=cor, max_nb=nb, max_i=mi, max_j=mj, best_sE=sE,
                hd1=hd1, hd2=hd2)
