"""Batched fold engine on the device (jit/vmap, fixed shapes).

A from-scratch device-first redesign of the reference's beam BFS
(/root/reference/rafft/rafft.py:112-239).  Key design decisions:

* **Beam state is just pair tables + energies.**  The reference's
  region bookkeeping (Node pos_lists built by slicing/concatenating
  encodings, utils.py:141-152) is provably equivalent to "the unpaired
  positions of each loop of the current structure", so regions are
  re-derived on device from the pair table each step (one masked
  max-reduction; see energy/eval_jax.analyze_pt).  Only the *ordering*
  of regions (the reference's node_list order, which fixes product
  enumeration and tie-breaks) is carried explicitly (`rorder`).

* **Integer incremental dE.**  Energies are loop-additive integers, so a
  candidate stem's dE is stacks-along-stem + inner hairpin + the
  enclosing-loop transition (hairpin->two-loop->multiloop/exterior), all
  O(1) gathers — no O(N) re-evaluation, and cross-region combinations
  need no evaluation at all (dE's add exactly).  Candidates whose stem
  jumps an excised gap or swallows old stems ("complex") fall back to
  the full batched evaluator under a fixed budget.

* **No scatters in the hot path.**  Combination pair tables are built
  position-wise (each position computes its own partner from the chosen
  candidates), so stems of any length cost O(1) per position.

* On the GPU, correlation and window slide run as one lag-indexed
  anti-diagonal sweep (engine/wavefront.py) within its shape limits;
  elsewhere the
  correlation is a batched real FFT over fixed-size padded regions,
  rounded back to exact integers for the default integer pair weights,
  so lag ranking is deterministic.

Parity notes: results match the CPU engine except for (a) float32 vs
float64 correlation tie noise, (b) the reference's max_branch overshoot
quirk (cap checked after each add), (c) complex-candidate budget
overflow — all counted in the returned stats.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp

import rafft_tpu.jax_setup  # noqa: F401  (persistent compile cache)
from rafft_tpu.energy.params import get_params, encode_sequence
from rafft_tpu.energy import eval_jax as EJ
from rafft_tpu.energy.eval_jax import (device_params, analyze_pt, eval_pt,
                                       _ptype, _g, _sget_vec, _ml_stem,
                                       _ext_stem_v, _int_loop_v, _hairpin_v,
                                       _kmer_keys)
from rafft_tpu.scan.encode import CHANNEL_CODES, weight_matrix
from rafft_tpu.engine.lookup import (flat_lookup, batched_taa,
                                     row_lookup, assume_batched)
from rafft_tpu.engine.wavefront import supported, wavefront_tables

NEG = np.float32(-3.0e38)

# exactness-flag bits (out_flag / enum_suspect): which budget tripped.
# Any nonzero flag routes the sequence to the CPU-parity refold pool;
# the sweep emits a per-cause histogram (tools/fallback_hist.py)
FLAG_VWINDOW = 1    # combination V-window truncated reference combos
FLAG_RSLOTS = 2     # live regions exceeded the R slots
FLAG_SEEN = 4       # seen-set capacity S overflowed (dedup voided)
FLAG_HASH = 8       # _CHECK_HASH mismatch (debug builds only)
FLAG_CPLX = 16      # complex-candidate full-eval budget overflowed
FLAG_STEPLIM = 32   # fold hit the step safety limit unfinished

# filled with _candidate_delta intermediates when set to a dict (debug
# tooling only; populated in eager mode, no effect under jit)
DEBUG_CAPTURE = None

# test-only invariant check: rebuild combination pair tables in full and
# verify the composed incremental hashes match _hash() of the real table
# (mismatches are counted into enum_suspect, which tests assert == 0)
_CHECK_HASH = False

# profiling-only stage cut (tools/profile_step.py): when set to a stage
# name, _seq_step returns right after that stage with the stage's
# outputs folded into a live scalar, so XLA dead-code-eliminates all
# later stages — cumulative timings per cut give the per-stage profile.
# No effect when None (the production value).
_PROFILE_CUT = None

_STAGES = ("analyze", "regions", "corr", "wscan", "cdelta", "cplx_sel",
           "cplx_pt", "cplx", "accept", "enum", "pool", "full")


def _live_mix(vals, done):
    """Fold arbitrary stage outputs into one un-DCE-able int32 scalar."""
    mix = jnp.int32(0)
    for v in vals:
        x = v.astype(jnp.float32) if v.dtype == bool else v
        s = x.sum().astype(jnp.float32)
        # data-dependent select: XLA cannot fold it away
        mix = mix + jnp.where(s == jnp.float32(-3.25e37),
                              jnp.int32(1), jnp.int32(0))
    return jnp.where(done.any() & (mix > 0), mix, jnp.int32(0))


@dataclass(frozen=True)
class EngineConfig:
    N: int = 128          # padded sequence length (bucket)
    K: int = 5            # beam width (max_stack)
    R: int = 8            # max regions per structure
    M: int = 100          # lags searched per region (nb_mode)
    V: int = 256          # combination slots per enumeration window
    W: int = 8            # max enumeration windows per step (see
                          # _seq_step: the combo space is walked in
                          # lexicographic V-slabs until the reference's
                          # max_branch new-structure cap or exhaustion)
    CPLX: int = 512       # complex-candidate full-eval budget per sequence/step
    S: int = 2048         # seen-set capacity per sequence
    max_steps: int = 24
    max_branch: int = 1000
    min_hp: int = 3
    min_nrj: float = 0.0
    temp: float = 37.0
    gc_wei: float = 3.0
    au_wei: float = 2.0
    gu_wei: float = 1.0


def _weights_integral(cfg):
    return all(float(w) == int(w) for w in (cfg.gc_wei, cfg.au_wei, cfg.gu_wei))


# ======================================================================
# per-step computation
# ======================================================================

def _regions(cfg, pt, enclose, rorder, n):
    """Compact each ordered region's member positions.

    Returns rpos [K,R,N] (member positions ascending, N-padded),
    rloc [K,N] (local index of each position within its region; R*N if
    none), mlen [K,R]."""
    K, R, N = cfg.K, cfg.R, cfg.N
    ii = jnp.arange(N, dtype=jnp.int32)

    unpaired = (pt < 0) & (ii[None, :] < n)          # [K,N]
    # label of every position = innermost enclosing opening (-1 exterior)
    lab = enclose                                     # [K,N]

    # match positions to ordered region slots
    memb = (unpaired[:, None, :]
            & (lab[:, None, :] == rorder[:, :, None])
            & (rorder[:, :, None] > -2))              # [K,R,N]
    rpos = jnp.sort(jnp.where(memb, ii[None, None, :], N), axis=-1)
    mlen = memb.sum(axis=-1).astype(jnp.int32)

    # local index of position x in its region (for combo construction)
    loc_in_reg = jnp.cumsum(memb, axis=-1) - 1        # [K,R,N]
    rslot = jnp.argmax(memb, axis=1).astype(jnp.int32)  # [K,N]
    has = memb.any(axis=1)
    rloc = jnp.where(has, jnp.take_along_axis(
        loc_in_reg, rslot[:, None, :], axis=1)[:, 0], -1).astype(jnp.int32)
    rslot = jnp.where(has, rslot, -1)
    return rpos, rloc, rslot, mlen


def _correlate(cfg, W, rcodes, mlen, integral):
    """Normalised correlation per region: [K,R,2N-1]."""
    N = cfg.N
    ch = jnp.asarray(CHANNEL_CODES)
    fwd = (rcodes[..., None, :] == ch[:, None]).astype(jnp.float32)  # [K,R,4,N]
    Wn = np.asarray(W, dtype=np.float32)
    cols = []
    for c in np.asarray(CHANNEL_CODES):
        acc = jnp.zeros(rcodes.shape, jnp.float32)
        for v in range(Wn.shape[1]):
            if Wn[c, v] != 0:
                acc = jnp.where(rcodes == v, jnp.float32(Wn[c, v]), acc)
        cols.append(acc)
    wen = jnp.stack(cols, axis=-2)                                   # [K,R,4,N]
    F = 2 * N
    conv = jnp.fft.irfft(jnp.fft.rfft(fwd, n=F) * jnp.fft.rfft(wen, n=F),
                         n=F)[..., : 2 * N - 1]
    cor = conv.sum(axis=-2)
    if integral:
        cor = jnp.round(cor)
    return _normalise(cor, mlen, N)


def _normalise(cor_raw, mlen, N):
    """Raw per-lag correlation sums [..., 2N] -> the normalised
    correlation _correlate returns, [..., 2N-1]."""
    lag = jnp.arange(2 * N - 1, dtype=jnp.int32)
    m = mlen[..., None]
    norm = (jnp.minimum(lag, jnp.maximum(2 * m - 2 - lag, 0))
            + jnp.float32(1.0))
    return jnp.where(lag < 2 * m - 1, cor_raw[..., : 2 * N - 1] / norm, NEG)


def _top_lags(cfg, cor):
    """Descending value, ties by descending lag (reference order,
    scan/correlate.top_lags).  A stable sort is required: lax.top_k's
    tie order is unspecified and can vary across compilations."""
    rev = cor[..., ::-1]
    idx = jnp.argsort(rev, axis=-1, stable=True,
                      descending=True)[..., : cfg.M].astype(jnp.int32)
    vals = batched_taa(rev, idx)
    lags = (cor.shape[-1] - 1) - idx
    return lags.astype(jnp.int32), vals


def _window_scan(cfg, dp, W, rcodes, rpos, mlen, lags, lag_ok,
                 z1row=None, z2row=None):
    """Vectorised window-slide over all (k, r, m) lanes at once.

    Strategy: every lane's window is the anti-diagonal ip + jp = lag
    of the (region-local) pair matrix, so all positions a lane will ever
    visit are gathered ONCE into [H, K, R, M] diagonal arrays (one big
    gather each); the neighbour values the recurrence needs (ip-1, jp+1)
    are shifts along the diagonal.  The reference recurrence then runs as
    a sequential elementwise loop over H with zero gathers inside — each
    step reads one [K,R,M] slab of the precomputed arrays — with a
    dynamic trip count (no lane scans past its own window's half, and
    regions shrink fast after the first fold step).

    Returns per-candidate best run info + stack-energy prefix, all
    [K,R,M]."""
    K, R, M, N = cfg.K, cfg.R, cfg.M, cfg.N
    H = N // 2 + 1

    m = mlen[:, :, None]                                   # [K,R,1]
    lag = lags                                             # [K,R,M]
    w_width = jnp.where(lag < m, lag + 1, 2 * m - lag - 1)
    half = w_width // 2 + (w_width % 2)
    base = jnp.maximum(lag - m + 1, 0)                     # [K,R,M]

    io = jnp.arange(H, dtype=jnp.int32)[:, None, None, None]
    idx5 = base[None] + io                                 # [H,K,R,M] = ip
    idx3 = lag[None] - idx5                                #           = jp

    # Window members are contiguous runs: idx5 walks forward from base,
    # idx3 walks backward from e := lag - base.  Gathering per (lag,
    # step) would be a [*,N]@[N,2] one-hot dot (a 2-wide output);
    # instead gather ONCE per window START against Hankel
    # stacks of shifted tables (H static slices), so the extraction is a
    # proper [M,N]@[N,H*2] matmul per region.  In-window reads (i < half)
    # always land inside [0, mlen) so the zero padding is never consumed.
    # A bf16 one-hot selects values <= 256 exactly, and a bf16 result
    # holds them exactly (the CPU backend has no bf16 x bf16 -> f32 dot).
    if N <= 256:
        dt, prec = jnp.bfloat16, jax.lax.Precision.DEFAULT
    else:
        dt, prec = jnp.float32, jax.lax.Precision.HIGHEST
    T2 = jnp.stack([rcodes.astype(dt), rpos.astype(dt)], axis=-1)  # [K,R,N,2]
    zpad = jnp.zeros(T2.shape[:-2] + (H, 2), dt)
    padf = jnp.concatenate([T2, zpad], axis=-2)            # [K,R,N+H,2]
    padb = jnp.concatenate([zpad, T2], axis=-2)
    Sf = jnp.stack([padf[..., i:i + N, :] for i in range(H)],
                   axis=-3)                                # [K,R,H,N,2]
    Sb = jnp.stack([padb[..., H - i:H - i + N, :] for i in range(H)],
                   axis=-3)
    nn = jnp.arange(N, dtype=jnp.int32)
    oh5 = (base[..., None] == nn).astype(dt)               # [K,R,M,N]
    oh3 = ((lag - base)[..., None] == nn).astype(dt)
    d5 = jnp.einsum('...mn,...hnt->h...mt', oh5, Sf, precision=prec,
                    preferred_element_type=dt)
    d3 = jnp.einsum('...mn,...hnt->h...mt', oh3, Sb, precision=prec,
                    preferred_element_type=dt)
    c5 = d5[..., 0].astype(jnp.int32)
    p5 = d5[..., 1].astype(jnp.int32)
    c3 = d3[..., 0].astype(jnp.int32)
    p3 = d3[..., 1].astype(jnp.int32)

    def shift1(x, fill):                       # value at diagonal step i-1
        return jnp.concatenate(
            [jnp.full_like(x[:1], fill), x[:-1]], axis=0)

    c5m = shift1(c5, 0)                        # rcodes[ip-1]
    c3p = shift1(c3, 0)                        # rcodes[jp+1]
    p5m = shift1(p5, -9)                       # rpos[ip-1]
    p3p = shift1(p3, -9)                       # rpos[jp+1]

    # hash-coefficient channels Z[rpos] (32-bit): extracted separately
    # in exact 16-bit halves (the main extraction may run bf16)
    if z1row is None:
        z1row = jnp.zeros(rpos.shape, jnp.int32)
    if z2row is None:
        z2row = jnp.zeros(rpos.shape, jnp.int32)
    lo = lambda x: (x.astype(jnp.uint32) & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = lambda x: (x.astype(jnp.uint32) >> 16).astype(jnp.int32)
    ZT = jnp.stack([lo(z1row), hi(z1row), lo(z2row), hi(z2row)],
                   axis=-1).astype(jnp.float32)            # [K,R,N,4]
    zzpad = jnp.zeros(ZT.shape[:-2] + (H, 4), jnp.float32)
    zpadf = jnp.concatenate([ZT, zzpad], axis=-2)
    zpadb = jnp.concatenate([zzpad, ZT], axis=-2)
    Zf = jnp.stack([zpadf[..., i:i + N, :] for i in range(H)], axis=-3)
    Zb = jnp.stack([zpadb[..., H - i:H - i + N, :] for i in range(H)],
                   axis=-3)
    d5z = jnp.einsum('...mn,...hnt->h...mt', oh5.astype(jnp.float32), Zf,
                     precision=jax.lax.Precision.HIGHEST)
    d3z = jnp.einsum('...mn,...hnt->h...mt', oh3.astype(jnp.float32), Zb,
                     precision=jax.lax.Precision.HIGHEST)

    def comb(d, a_, b_):
        return ((d[..., b_].astype(jnp.int32) << 16)
                | d[..., a_].astype(jnp.int32))

    z1_5 = comb(d5z, 0, 1)
    z2_5 = comb(d5z, 2, 3)
    z1_3 = comb(d3z, 0, 1)
    z2_3 = comb(d3z, 2, 3)
    # per-cell hash delta of pairing (p5, p3): Z[p5]*(p3+1)+Z[p3]*(p5+1)
    # (int32 wraparound == uint32 mod 2^32)
    zc1 = z1_5 * (p3 + 1) + z1_3 * (p5 + 1)                # [H,K,R,M]
    zc2 = z2_5 * (p3 + 1) + z2_3 * (p5 + 1)

    # pair weight + pair type via sparse select chains (W and PAIR_TYPE
    # have only 6 nonzero entries each); both tables are host constants
    Wn = np.asarray(W, dtype=np.float32)
    PTn = np.asarray(dp.pair_type)

    def wchain(a, b):
        lin = a * 5 + b
        out = jnp.zeros(lin.shape, jnp.float32)
        for v, x in enumerate(Wn.reshape(-1)):
            if x != 0:
                out = jnp.where(lin == v, jnp.float32(x), out)
        return out

    def pchain(a, b):
        lin = a * 5 + b
        out = jnp.full(lin.shape, jnp.int32(7))
        for v, x in enumerate(PTn.reshape(-1)):
            if x != 0:
                out = jnp.where(lin == v, jnp.int32(x), out)
        return out

    w = wchain(c5, c3)                                       # [H,K,R,M] f32
    contig = (io > 0) & (p5 - p5m == 1) & (p3p - p3 == 1)
    # stack energy between pair (ip-1, jp+1) [outer] and (ip, jp)
    g = flat_lookup(dp.stack.reshape(-1),
                    pchain(c5m, c3p) * 8 + pchain(c3, c5))
    in_win = (io < half[None]) & lag_ok[None]
    upd_ok = in_win & ((p3 - p5) > cfg.min_hp)

    shape = (K, R, M)
    state = dict(
        tot=jnp.zeros(shape, jnp.float32),
        tmp_max=jnp.zeros(shape, jnp.int32),
        max_score=jnp.zeros(shape, jnp.float32),
        max_nb=jnp.zeros(shape, jnp.int32),
        max_i=jnp.zeros(shape, jnp.int32),
        max_j=jnp.zeros(shape, jnp.int32),
        sE=jnp.zeros(shape, jnp.int32),
        best_sE=jnp.zeros(shape, jnp.int32),
        hd1=jnp.zeros(shape, jnp.int32),
        hd2=jnp.zeros(shape, jnp.int32),
        best_h1=jnp.zeros(shape, jnp.int32),
        best_h2=jnp.zeros(shape, jnp.int32),
    )

    def body(i, st):
        wi = w[i]
        ci = contig[i]
        gi = g[i]
        iw = in_win[i]
        uo = upd_ok[i]

        tot_prev = st["tot"]
        tot = jnp.where(ci, (tot_prev + wi) * wi, wi)
        tmp_max = jnp.where(tot == 0, 0, st["tmp_max"] + 1)
        # accumulates over contiguous steps of the current run; resets
        # when the run resets (tot==0); held (not added) across gap
        # steps — gap steps contribute their own multiloop term later
        in_run = (tot != 0) & (tot_prev != 0) & ci
        sE = jnp.where((tot == 0) | (tot_prev == 0), 0,
                       jnp.where(in_run, st["sE"] + gi, st["sE"]))
        # hash delta accumulates over exactly the cells tmp_max counts
        hd1 = jnp.where(tot == 0, 0, st["hd1"] + zc1[i])
        hd2 = jnp.where(tot == 0, 0, st["hd2"] + zc2[i])
        upd = uo & (tot >= st["max_score"])
        ip = base + i
        jp = lag - ip

        st = dict(st)
        st["tot"] = jnp.where(iw, tot, st["tot"])
        st["tmp_max"] = jnp.where(iw, tmp_max, st["tmp_max"])
        st["sE"] = jnp.where(iw, sE, st["sE"])
        st["hd1"] = jnp.where(iw, hd1, st["hd1"])
        st["hd2"] = jnp.where(iw, hd2, st["hd2"])
        st["max_score"] = jnp.where(upd, tot, st["max_score"])
        st["max_nb"] = jnp.where(upd, tmp_max, st["max_nb"])
        st["max_i"] = jnp.where(upd, ip, st["max_i"])
        st["max_j"] = jnp.where(upd, jp, st["max_j"])
        st["best_sE"] = jnp.where(upd, sE, st["best_sE"])
        st["best_h1"] = jnp.where(upd, hd1, st["best_h1"])
        st["best_h2"] = jnp.where(upd, hd2, st["best_h2"])
        return st

    h_dyn = jnp.minimum(jnp.max(jnp.where(lag_ok, half, 0)), jnp.int32(H))

    def cond(carry):
        i, _ = carry
        return i < h_dyn

    def wbody(carry):
        i, st = carry
        return i + 1, body(i, st)

    _, st = jax.lax.while_loop(cond, wbody, (jnp.int32(0), state))
    return st


def scan_tables(cfg, dp, W, rcodes, rpos, mlen, z1row, z2row, path,
                active=None, interpret=False):
    """Correlation, top lags and per-lag window-scan results of one
    sequence's regions, as the fold step consumes them.

    path: 'wavefront' (engine/wavefront.py; `interpret` runs its kernel
    through the Pallas interpreter) or 'fft' (_correlate + _window_scan).  Returns (cor, lags, lvals,
    lag_ok, ws); lag_ok also masks beam rows that are not `active`."""
    N = cfg.N
    if path == "wavefront":
        tabs = wavefront_tables(cfg, dp, W, rcodes, rpos, mlen, z1row,
                                z2row, interpret=interpret)
        cor = _normalise(tabs["cor_raw"], mlen, N)
    else:
        cor = _correlate(cfg, W, rcodes, mlen, _weights_integral(cfg))
    lags, lvals = _top_lags(cfg, cor)
    lag_ok = (lvals > NEG / 2) & (mlen[:, :, None] >= 2)
    if active is not None:
        lag_ok = lag_ok & active[:, None, None]
    if path != "wavefront":
        ws = _window_scan(cfg, dp, W, rcodes, rpos, mlen, lags, lag_ok,
                          z1row=z1row, z2row=z2row)
        return cor, lags, lvals, lag_ok, dict(ws, hd1=ws["best_h1"],
                                              hd2=ws["best_h2"])
    # one one-hot contraction gathers all eight per-lag fields at the
    # selected lags (hash deltas in exact 16-bit halves)
    u32t = lambda x: x.astype(jnp.uint32)
    i32t = lambda x: x.astype(jnp.int32)
    tab8 = jnp.stack(
        [tabs["max_nb"], tabs["max_i"], tabs["max_j"], tabs["best_sE"],
         i32t(u32t(tabs["hd1"]) & 0xFFFF), i32t(u32t(tabs["hd1"]) >> 16),
         i32t(u32t(tabs["hd2"]) & 0xFFFF), i32t(u32t(tabs["hd2"]) >> 16)],
        axis=-1)
    oh = (lags[..., None] == jnp.arange(2 * N, dtype=jnp.int32)
          ).astype(jnp.float32)
    g8 = jnp.einsum('...mx,...xt->...mt', oh, tab8.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    ws = dict(max_nb=g8[..., 0], max_i=g8[..., 1], max_j=g8[..., 2],
              best_sE=g8[..., 3], hd1=(g8[..., 5] << 16) | g8[..., 4],
              hd2=(g8[..., 7] << 16) | g8[..., 6])
    return cor, lags, lvals, lag_ok, ws


def _children(cfg, pt, loops, rorder, C):
    """Per (k, r): the enclosing loop's direct children, ascending, with
    prefix sums of their multiloop-stem terms and spans.

    Returns chs [K,R,C] (starts, N-padded), pml [K,R,C+1], pspan [K,R,C+1],
    nch [K,R], mls [K,N] (per-opening multiloop stem term)."""
    K, R, N = cfg.K, cfg.R, cfg.N
    ii = jnp.arange(N, dtype=jnp.int32)
    is_open = loops["is_open"]                           # [K,N]
    enclose = loops["enclose"]

    memb = (is_open[:, None, :]
            & (enclose[:, None, :] == rorder[:, :, None])
            & (rorder[:, :, None] > -2))                 # [K,R,N]
    order = jnp.argsort(jnp.where(memb, ii[None, None, :], N), axis=-1)
    chs_full = batched_taa(
        jnp.where(memb, ii[None, None, :], N)[..., 0:N], order)
    chs = chs_full[..., :C]
    nch = memb.sum(axis=-1).astype(jnp.int32)

    mls = loops["mls"]                                   # [K,N]
    mls_r = batched_taa(
        jnp.broadcast_to(mls[:, None, :], (K, R, N)),
        jnp.clip(chs, 0, N - 1))
    mls_r = jnp.where(chs < N, mls_r, 0)
    pml = jnp.concatenate(
        [jnp.zeros((K, R, 1), jnp.int32), jnp.cumsum(mls_r, axis=-1)], axis=-1)

    ptk = jnp.broadcast_to(pt[:, None, :], (K, R, N))
    che = batched_taa(ptk, jnp.clip(chs, 0, N - 1))
    span = jnp.where(chs < N, che - chs + 1, 0)
    pspan = jnp.concatenate(
        [jnp.zeros((K, R, 1), jnp.int32), jnp.cumsum(span, axis=-1)], axis=-1)

    # per-child exterior-loop term (needed when an exterior stem swallows
    # former top-level stems: their ext terms leave the total)
    exts = loops["exts"]                                 # [K,N]
    ext_r = batched_taa(
        jnp.broadcast_to(exts[:, None, :], (K, R, N)),
        jnp.clip(chs, 0, N - 1))
    ext_r = jnp.where(chs < N, ext_r, 0)
    pext = jnp.concatenate(
        [jnp.zeros((K, R, 1), jnp.int32), jnp.cumsum(ext_r, axis=-1)], axis=-1)
    return chs, pml, pspan, pext, nch


def _candidate_delta(cfg, dp, codes, n, keys, pt, loops, rorder,
                     rpos, mlen, ws, lags, C=48):
    """Exact incremental integer dE for every candidate [K,R,M].

    Formulation: the (r, m) candidate lanes are first COMPACTED to
    [K, CC] slots, CC = min(2N, R*M).  Per region only
    v_r = min(M, 2*mlen_r - 1) lags are real, and top_lags sorts the
    NEG-filled invalid lags last so they form a prefix in m; regions
    partition the <= N unpaired positions, so sum_r v_r < 2N always —
    the compaction loses nothing.  Every per-candidate table gather
    then runs at CC lanes instead of R*M (6.25x fewer at the bench
    config) as stacked-table one-hot einsums (engine/lookup.py's
    formulation); gathers sharing
    an index array share one one-hot.  Results scatter back to [K,R,M];
    lanes outside the compaction are exactly the lag_ok=False lanes the
    caller's masking already ignores.

    Semantics (unchanged): the stem's innermost pair may enclose old
    stems (hairpin / two-loop / multiloop by child count), and the
    enclosing loop transitions by gaining the stem and losing swallowed
    children — all resolved with interval queries over per-loop child
    prefix sums.  Candidates whose stem jumps an excised gap (~1% in
    practice — each jump creates a zero-unpaired multiloop mid-stem) or
    whose region has > C children are flagged unsupported and resolved
    by full evaluation under the CPLX budget; gap detection is O(1) per
    candidate via prefix sums of the region's position discontinuities."""
    K, R, M, N = cfg.K, cfg.R, cfg.M, cfg.N
    CC = min(2 * N, R * M)
    key5, key6, key8 = keys
    f32 = jnp.float32
    i32 = jnp.int32
    HI = jax.lax.Precision.HIGHEST
    nn = jnp.arange(N, dtype=i32)
    ccv = jnp.arange(CC, dtype=i32)

    # ---------- compaction maps ----------
    vr = jnp.where(mlen >= 2, jnp.minimum(M, 2 * mlen - 1), 0)   # [K,R]
    ends = jnp.cumsum(vr, axis=-1)                               # [K,R]
    starts = ends - vr
    r_of = (ends[:, :, None] <= ccv[None, None, :]).sum(1).astype(i32)
    r_ofc = jnp.clip(r_of, 0, R - 1)
    oh_r = (r_ofc[..., None] == jnp.arange(R, dtype=i32)).astype(f32)
    start_c = jnp.einsum('kcr,kr->kc', oh_r, starts.astype(f32),
                         precision=HI).astype(i32)
    m_ofc = jnp.clip(ccv[None, :] - start_c, 0, M - 1)
    oh_m = (m_ofc[..., None] == jnp.arange(M, dtype=i32)).astype(f32)

    # ---------- compact per-candidate scan results ----------
    Fsm = jnp.stack([ws["max_nb"], ws["max_i"], ws["max_j"],
                     ws["best_sE"]], axis=-1).astype(f32)        # [K,R,M,4]
    s1 = jnp.einsum('kcm,krmt->kcrt', oh_m, Fsm, precision=HI)
    s2 = jnp.einsum('kcr,kcrt->kct', oh_r, s1, precision=HI)
    run = s2[..., 0].astype(i32)
    i_s = s2[..., 1].astype(i32)
    j_s = s2[..., 2].astype(i32)
    bsE = s2[..., 3].astype(i32)
    has = run > 0

    # ---------- per-candidate region tables ----------
    jump5 = jnp.concatenate(
        [jnp.zeros((K, R, 1), i32),
         ((rpos[..., 1:] - rpos[..., :-1]) > 1).astype(i32)], axis=-1)
    cumJ = jnp.cumsum(jump5, axis=-1)                            # [K,R,N]
    RT = jnp.stack([rpos, cumJ], axis=-1).astype(f32)            # [K,R,N,2]
    rt_c = jnp.einsum('kcr,krnt->kcnt', oh_r, RT, precision=HI)  # [K,CC,N,2]

    def posg(idx):
        """(rpos, cumJ) at clip(idx) — one one-hot, two tables."""
        oh = (jnp.clip(idx, 0, N - 1)[..., None] == nn).astype(f32)
        out = jnp.einsum('kcn,kcnt->kct', oh, rt_c, precision=HI)
        return out[..., 0].astype(i32), out[..., 1].astype(i32)

    p0, cj_p = posg(i_s)                    # innermost 5'
    q0, cj_q = posg(j_s)                    # innermost 3'
    a, cj_a = posg(i_s - run + 1)           # outermost 5'
    b2, cj_b = posg(j_s + run - 1)          # outermost 3'

    # gap-jump detection: consecutive stem pairs jump a gap iff region
    # positions are discontinuous inside the run's contiguous local
    # ranges — prefix-sum differences of the discontinuity markers
    ngaps = jnp.where(run > 0, (cj_p - cj_a) + (cj_b - cj_q), 0)

    # ---------- children of each region's enclosing loop ----------
    chs, pml, pspan, pext, nch = _children(cfg, pt, loops, rorder, C)
    Ceff = chs.shape[-1]           # = min(C, N): _children slices to N
    CP1 = Ceff + 1
    CH = jnp.stack([
        jnp.concatenate([chs, jnp.full((K, R, 1), N, i32)], axis=-1),
        pml, pext], axis=-1).astype(f32)                         # [K,R,Ceff+1,3]
    ch_c = jnp.einsum('kcr,krxt->kcxt', oh_r, CH, precision=HI)  # [K,CC,Ceff+1,3]
    chs_c = ch_c[..., :Ceff, 0].astype(i32)
    pml_c = ch_c[..., 1]
    pext_c = ch_c[..., 2]
    sm = jnp.stack([nch.astype(f32), rorder.astype(f32)], axis=-1)
    sm_c = jnp.einsum('kcr,krt->kct', oh_r, sm, precision=HI)
    nch_c = sm_c[..., 0].astype(i32)
    lab = sm_c[..., 1].astype(i32)

    def ssr(q):  # first child index with start > q     [K,CC]
        return (chs_c <= q[..., None]).sum(-1).astype(i32)

    def ssl(q):  # first child index with start >= q
        return (chs_c < q[..., None]).sum(-1).astype(i32)

    xx = jnp.arange(CP1, dtype=i32)

    def ptake(pref, idx):
        oh = (jnp.clip(idx, 0, CP1 - 1)[..., None] == xx).astype(f32)
        return jnp.einsum('kcx,kcx->kc', oh, pref, precision=HI)

    def prange(pref, lo, hi):
        return (ptake(pref, hi) - ptake(pref, lo)).astype(i32)

    lo_in = ssr(p0)
    hi_in = ssl(q0)
    cin = hi_in - lo_in
    oh_fc = (jnp.clip(lo_in, 0, Ceff - 1)[..., None]
             == jnp.arange(Ceff, dtype=i32)).astype(f32)
    fc_in = jnp.einsum('kcx,kcx->kc', oh_fc, chs_c.astype(f32),
                       precision=HI).astype(i32)

    # ---------- fused value gathers ----------
    codes_m1 = jnp.concatenate([jnp.zeros(1, i32), codes[:-1]])
    codes_p1 = jnp.concatenate([codes[1:], jnp.zeros(1, i32)])
    CT = jnp.stack([codes, codes_m1, codes_p1], axis=-1).astype(f32)
    KT = jnp.stack([key5, key6, key8], axis=-1).astype(f32)

    def cg(idx, with_keys=False):
        """codes[i-1..i+1] (+ k-mer keys) at i = clip(idx) — one
        one-hot per index array.  Returns the raw gathered values; the
        call-site applies its own bounds convention via masks."""
        oh = (jnp.clip(idx, 0, N - 1)[..., None] == nn).astype(f32)
        cv = jnp.einsum('kcn,nt->kct', oh, CT, precision=HI).astype(i32)
        kv = (jnp.einsum('kcn,nt->kct', oh, KT, precision=HI).astype(i32)
              if with_keys else None)
        return oh, cv, kv

    def m_raw(vals, idx, off):
        # cvec convention: bounds on the RAW logical index idx+off
        j = idx + off
        return jnp.where((j >= 0) & (j < n), vals, 0)

    def m_clip(vals, idx, off):
        # _sget-after-clip convention: bounds on clip(idx)+off
        j = jnp.clip(idx, 0, N - 1) + off
        return jnp.where((j >= 0) & (j < n), vals, 0)

    oh_p0, cv_p0, kv_p0 = cg(p0, with_keys=True)
    _, cv_q0, _ = cg(q0)
    _, cv_a, _ = cg(a)
    _, cv_b2, _ = cg(b2)

    # ---------- inner loop closed by (p0, q0) ----------
    t_pq = _ptype(dp, m_clip(cv_p0[..., 0], p0, 0),
                  m_clip(cv_q0[..., 0], q0, 0))
    hpE = _hairpin_v(dp, t_pq,
                     m_clip(cv_p0[..., 2], p0, 1),
                     m_clip(cv_q0[..., 1], q0, -1),
                     jnp.clip(q0, 0, N - 1) - jnp.clip(p0, 0, N - 1) - 1,
                     kv_p0[..., 0], kv_p0[..., 1], kv_p0[..., 2],
                     use_chain=True)

    ptf = pt.astype(f32)
    _, cv_fc, _ = cg(fc_in)
    oh_fcN = (jnp.clip(fc_in, 0, N - 1)[..., None] == nn).astype(f32)
    fc_in_e = jnp.einsum('kcn,kn->kc', oh_fcN, ptf,
                         precision=HI).astype(i32)
    _, cv_fe, _ = cg(fc_in_e)
    t2_in = _ptype(dp, m_clip(cv_fe[..., 0], fc_in_e, 0),
                   m_clip(cv_fc[..., 0], fc_in, 0))
    ilE = _int_loop_v(dp, t_pq, t2_in,
                      m_clip(cv_p0[..., 2], p0, 1),
                      m_clip(cv_q0[..., 1], q0, -1),
                      m_clip(cv_fc[..., 1], fc_in, -1),
                      m_clip(cv_fe[..., 2], fc_in_e, 1),
                      jnp.clip(fc_in, 0, N - 1) - jnp.clip(p0, 0, N - 1) - 1,
                      jnp.clip(q0, 0, N - 1) - jnp.clip(fc_in_e, 0, N - 1) - 1)

    def mlstem_v(cv_x, x, cv_y, y):
        # stem (x, y) seen from its enclosing loop (raw-index bounds)
        t = _ptype(dp, m_raw(cv_x[..., 0], x, 0), m_raw(cv_y[..., 0], y, 0))
        return _ml_stem(dp, t, m_raw(cv_x[..., 1], x, -1),
                        m_raw(cv_y[..., 2], y, 1))

    def mlclose_v(cv_x, x, cv_y, y):
        # closing pair (x, y) seen from inside: reversed type
        t = _ptype(dp, m_raw(cv_y[..., 0], y, 0), m_raw(cv_x[..., 0], x, 0))
        return _ml_stem(dp, t, m_raw(cv_y[..., 1], y, -1),
                        m_raw(cv_x[..., 2], x, 1))

    mlE_in = (dp.ml_closing + mlclose_v(cv_p0, p0, cv_q0, q0)
              + prange(pml_c, lo_in, hi_in))
    innerE = jnp.where(cin == 0, hpE, jnp.where(cin == 1, ilE, mlE_in))

    # ---------- enclosing loop transition ----------
    labc = jnp.clip(lab, 0, N - 1)
    is_ext = lab == -1
    LT = jnp.stack([loops["branches"].astype(f32), loops["loop_e"].astype(f32),
                    ptf], axis=-1)                               # [K,N,3]
    oh_lab = (labc[..., None] == nn).astype(f32)
    lt_c = jnp.einsum('kcn,knt->kct', oh_lab, LT, precision=HI)
    bL = lt_c[..., 0].astype(i32)
    eL = lt_c[..., 1].astype(i32)
    j_lab = lt_c[..., 2].astype(i32)
    _, cv_lab, _ = cg(lab)
    _, cv_jl, _ = cg(j_lab)

    lo_sw = ssr(a - 1)     # children with start >= a
    hi_sw = ssl(b2 + 1)    # children with start <= b2
    sw = hi_sw - lo_sw
    mlsub = prange(pml_c, lo_sw, hi_sw)
    bLn = bL - sw + 1

    t1_L = _ptype(dp, m_clip(cv_lab[..., 0], lab, 0),
                  m_clip(cv_jl[..., 0], j_lab, 0))
    t2_L = _ptype(dp, m_clip(cv_b2[..., 0], b2, 0),
                  m_clip(cv_a[..., 0], a, 0))
    il_new = _int_loop_v(dp, t1_L, t2_L,
                         m_clip(cv_lab[..., 2], lab, 1),
                         m_clip(cv_jl[..., 1], j_lab, -1),
                         m_clip(cv_a[..., 1], a, -1),
                         m_clip(cv_b2[..., 2], b2, 1),
                         jnp.clip(a, 0, N - 1) - labc - 1,
                         jnp.clip(j_lab, 0, N - 1) - jnp.clip(b2, 0, N - 1) - 1)
    ml_total = ptake(pml_c, nch_c).astype(i32)
    mlE_L = (dp.ml_closing + mlclose_v(cv_lab, lab, cv_jl, j_lab)
             + ml_total - mlsub + mlstem_v(cv_a, a, cv_b2, b2))
    t_ext = _ptype(dp, m_clip(cv_a[..., 0], a, 0),
                   m_clip(cv_b2[..., 0], b2, 0))
    ext_new = _ext_stem_v(dp, t_ext,
                          m_clip(cv_a[..., 1], a, -1),
                          m_clip(cv_b2[..., 2], b2, 1),
                          jnp.clip(a, 0, N - 1) > 0,
                          jnp.clip(b2, 0, N - 1) < n - 1)
    ext_sub = prange(pext_c, lo_sw, hi_sw)

    dL = jnp.where(is_ext, ext_new - ext_sub,
                   jnp.where(bLn == 1, il_new - eL, mlE_L - eL))

    delta = bsE + innerE + dL

    if DEBUG_CAPTURE is not None:
        DEBUG_CAPTURE.update(innerE=innerE, dL=dL, cin=cin, hpE=hpE,
                             ilE=ilE, mlE_in=mlE_in, bL=bL, bLn=bLn, sw=sw,
                             il_new=il_new, eL=eL, is_ext=is_ext,
                             ext_new=ext_new, ext_sub=ext_sub, mlE_L=mlE_L,
                             a=a, b2=b2, p0=p0, q0=q0, ngaps=ngaps,
                             lo_sw=lo_sw, hi_sw=hi_sw, fc_in=fc_in,
                             fc_in_e=fc_in_e, lo_in=lo_in, hi_in=hi_in,
                             r_of=r_of, m_of=m_ofc, starts=starts, vr=vr)

    unsupported = has & ((ngaps > 0) | (nch_c > C))
    delta = jnp.where(has & ~unsupported, delta, 0)

    # ---------- scatter back to [K,R,M] ----------
    mm = jnp.arange(M, dtype=i32)
    c_rm = jnp.where(mm[None, None, :] < vr[..., None],
                     starts[..., None] + mm[None, None, :], CC)  # [K,R,M]
    oh_b = (c_rm[..., None] == ccv).astype(f32)                  # [K,R,M,CC]
    X = jnp.stack([delta.astype(f32), unsupported.astype(f32),
                   p0.astype(f32), q0.astype(f32), a.astype(f32),
                   b2.astype(f32)], axis=-1)                     # [K,CC,6]
    Y = jnp.einsum('krmc,kct->krmt', oh_b, X, precision=HI)
    delta_rm = Y[..., 0].astype(i32)
    cplx_rm = Y[..., 1] > 0.5
    p0_rm = Y[..., 2].astype(i32)
    q0_rm = Y[..., 3].astype(i32)
    a_rm = Y[..., 4].astype(i32)
    b2_rm = Y[..., 5].astype(i32)
    has_rm = ws["max_nb"] > 0
    return delta_rm, cplx_rm, has_rm, p0_rm, q0_rm, a_rm, b2_rm


def _combo_pt(cfg, pt_parent, rloc, rslot, rpos, chosen_i, chosen_j,
              chosen_run, chosen_on):
    """Position-wise construction of combination pair tables, batched.

    pt_parent/rloc/rslot are [V,N], rpos is [V,R,N], chosen_* are [V,R]
    candidate picks.  Every position derives its new partner from its
    region's chosen stem; all lookups are one-hot einsums (slow-gather
    avoidance, engine/lookup.py)."""
    N, R = cfg.N, cfg.R
    r = rslot                                          # [V,N]
    rc = jnp.clip(r, 0, R - 1)
    l = rloc                                           # [V,N] local index
    ci = batched_taa(chosen_i, rc)
    cj = batched_taa(chosen_j, rc)
    crun = batched_taa(chosen_run, rc)
    con = (batched_taa(chosen_on.astype(jnp.int32), rc) > 0) & (r >= 0)

    in5 = con & (l > ci - crun) & (l <= ci)
    in3 = con & (l >= cj) & (l < cj + crun)
    rflat = rpos.reshape(rpos.shape[0], R * N)
    part5 = batched_taa(rflat, jnp.clip(rc * N + cj + (ci - l), 0, R * N - 1))
    part3 = batched_taa(rflat, jnp.clip(rc * N + ci - (l - cj), 0, R * N - 1))
    return jnp.where(in5, part5, jnp.where(in3, part3, pt_parent))


# ======================================================================
# the engine
# ======================================================================

class FoldEngine:
    """Compiled batched fold engine for one (config, batch-size) pair."""

    def __init__(self, cfg: EngineConfig, B: int):
        if cfg.V < cfg.K:
            raise ValueError(f"V={cfg.V} must be >= K={cfg.K} (the "
                             "window top-K merge gathers K slots)")
        if cfg.M > 2 * cfg.N - 1:
            raise ValueError(
                f"M={cfg.M} exceeds the {2 * cfg.N - 1} correlation lags "
                f"of an N={cfg.N} region; clamp M to min(nb_mode, 2N-1) "
                f"(top-lag selection saturates there)")
        self.cfg = cfg
        self.B = B
        self.dp = device_params(cfg.temp, max_len=cfg.N)
        self.W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
        self.integral = _weights_integral(cfg)
        # correlation + window scan: the lag-indexed wavefront kernel on
        # the GPU within its shape limits, else the FFT correlation and
        # the Hankel-stack scan
        self.scan_path = ("wavefront" if jax.default_backend() == "gpu"
                          and supported(cfg, self.integral) else "fft")
        rng = np.random.default_rng(0xA5F7)
        z1 = rng.integers(1, 2**32 - 1, cfg.N + 1, dtype=np.uint64).astype(np.uint32)
        z2 = rng.integers(1, 2**32 - 1, cfg.N + 1, dtype=np.uint64).astype(np.uint32)
        self.Z1 = jnp.asarray(z1)
        self.Z2 = jnp.asarray(z2)
        # 16-bit halves (exact through the f32 one-hot lookup machinery)
        self.Z1lo = jnp.asarray((z1 & 0xFFFF).astype(np.int32))
        self.Z1hi = jnp.asarray((z1 >> 16).astype(np.int32))
        self.Z2lo = jnp.asarray((z2 & 0xFFFF).astype(np.int32))
        self.Z2hi = jnp.asarray((z2 >> 16).astype(np.int32))
        self._step = jax.jit(self._step_impl)
        self._refill = jax.jit(self._refill_impl)
        self._steps = jax.jit(self._steps_impl, static_argnums=(1,))
        # the streaming loop threads one state through advance/drain and
        # never reuses the old value, so donate it: XLA updates the beam
        # state in place instead of allocating + copying ~all of HBM's
        # working set every dispatch
        self._advance = jax.jit(self._advance_impl, static_argnums=(1,),
                                donate_argnums=(0,))
        self._drain_load = jax.jit(self._drain_load_impl,
                                   donate_argnums=(0,))

    # ---------------- state
    def init_state(self, seqs: list[str], seqids=None):
        cfg, B = self.cfg, self.B
        assert len(seqs) <= B
        codes = np.zeros((B, cfg.N), np.int32)
        n = np.zeros(B, np.int32)
        for b, s in enumerate(seqs):
            c = encode_sequence(s)
            assert len(c) <= cfg.N, (len(c), cfg.N)
            codes[b, : len(c)] = c
            n[b] = len(c)
        pt = np.full((B, cfg.K, cfg.N), -1, np.int32)
        energy = np.zeros((B, cfg.K), np.int32)
        active = np.zeros((B, cfg.K), bool)
        active[:, 0] = n > 0
        rorder = np.full((B, cfg.K, cfg.R), -2, np.int32)
        rorder[:, 0, 0] = -1          # exterior region of the unfolded root
        sid = np.full(B, -1, np.int32)
        if seqids is not None:
            sid[: len(seqids)] = seqids
        return dict(
            codes=jnp.asarray(codes), n=jnp.asarray(n),
            pt=jnp.asarray(pt), energy=jnp.asarray(energy),
            active=jnp.asarray(active), rorder=jnp.asarray(rorder),
            seen_h1=jnp.zeros((B, cfg.S), jnp.uint32),
            seen_h2=jnp.zeros((B, cfg.S), jnp.uint32),
            seen_cnt=jnp.zeros(B, jnp.int32),
            done=jnp.asarray(n == 0),
            cplx_dropped=jnp.zeros(B, jnp.int32),
            enum_suspect=jnp.zeros(B, jnp.int32),
            # device-side continuous batching: per-lane shadow sequence,
            # output buffer for one finished fold, and bookkeeping
            seqid=jnp.asarray(sid),
            lane_steps=jnp.zeros(B, jnp.int32),
            next_codes=jnp.zeros((B, cfg.N), jnp.int32),
            next_n=jnp.zeros(B, jnp.int32),
            next_seqid=jnp.full(B, -1, jnp.int32),
            next_avail=jnp.zeros(B, bool),
            out_pt=jnp.full((B, cfg.K, cfg.N), -1, jnp.int32),
            out_E=jnp.zeros((B, cfg.K), jnp.int32),
            out_act=jnp.zeros((B, cfg.K), bool),
            out_n=jnp.zeros(B, jnp.int32),
            out_seqid=jnp.full(B, -1, jnp.int32),
            out_done=jnp.zeros(B, bool),
            out_flag=jnp.zeros(B, jnp.int32),
            out_valid=jnp.zeros(B, bool),
        )

    def _refill_impl(self, state, mask, codes_new, n_new):
        """Reset masked batch slots to the unfolded root of new sequences
        (continuous batching: finished slots take fresh work mid-flight)."""
        cfg = self.cfg
        K, R = cfg.K, cfg.R
        m1 = mask[:, None]
        m2 = mask[:, None, None]
        kk = jnp.arange(K, dtype=jnp.int32)
        root_active = (kk[None, :] == 0) & (n_new[:, None] > 0)
        root_rorder = jnp.where((kk[:, None] == 0)
                                & (jnp.arange(R)[None, :] == 0),
                                jnp.int32(-1), jnp.int32(-2))
        st = dict(state)
        st["codes"] = jnp.where(m1, codes_new, state["codes"])
        st["n"] = jnp.where(mask, n_new, state["n"])
        st["pt"] = jnp.where(m2, jnp.int32(-1), state["pt"])
        st["energy"] = jnp.where(m1, 0, state["energy"])
        st["active"] = jnp.where(m1, root_active, state["active"])
        st["rorder"] = jnp.where(m2, root_rorder[None], state["rorder"])
        st["seen_h1"] = jnp.where(m1, jnp.uint32(0), state["seen_h1"])
        st["seen_h2"] = jnp.where(m1, jnp.uint32(0), state["seen_h2"])
        st["seen_cnt"] = jnp.where(mask, 0, state["seen_cnt"])
        st["done"] = jnp.where(mask, n_new == 0, state["done"])
        st["cplx_dropped"] = jnp.where(mask, 0, state["cplx_dropped"])
        st["enum_suspect"] = jnp.where(mask, 0, state["enum_suspect"])
        return st

    def refill(self, state, slots, seqs):
        """Host API: place `seqs` into batch slots `slots` (lists)."""
        cfg, B = self.cfg, self.B
        mask = np.zeros(B, bool)
        codes = np.zeros((B, cfg.N), np.int32)
        n = np.zeros(B, np.int32)
        for b, s in zip(slots, seqs):
            mask[b] = True
            if s is not None:
                c = encode_sequence(s)
                assert len(c) <= cfg.N, (len(c), cfg.N)
                codes[b, : len(c)] = c
                n[b] = len(c)
        return self._refill(state, jnp.asarray(mask), jnp.asarray(codes),
                            jnp.asarray(n))

    def _hash(self, pt):
        v = (pt + 2).astype(jnp.uint32)
        h1 = (v * self.Z1[: self.cfg.N]).sum(axis=-1)
        h2 = (v * self.Z2[: self.cfg.N]).sum(axis=-1)
        return h1, h2

    def region_layout(self, codes, n, pt, rorder):
        """One sequence's loops and ordered regions: analyze_pt per beam
        row, the compacted region rows (rpos/rcodes, N-padded), each
        position's region slot and local index, and the hash
        coefficients Z[rpos] of the incremental candidate hashes."""
        cfg, dp, N = self.cfg, self.dp, self.cfg.N
        with assume_batched():
            loops = jax.vmap(lambda p: analyze_pt(dp, codes, p, n))(pt)
        rpos, rloc, rslot, mlen = _regions(cfg, pt, loops["enclose"],
                                           rorder, n)
        rcodes = jnp.where(rpos < N,
                           flat_lookup(codes, jnp.clip(rpos, 0, N - 1)), 0)
        # 16-bit-half lookups, recombined bitwise
        rposc = jnp.clip(rpos, 0, N)
        z1row = ((flat_lookup(self.Z1hi, rposc) << 16)
                 | flat_lookup(self.Z1lo, rposc))
        z2row = ((flat_lookup(self.Z2hi, rposc) << 16)
                 | flat_lookup(self.Z2lo, rposc))
        return dict(loops=loops, rpos=rpos, rloc=rloc, rslot=rslot,
                    mlen=mlen, rcodes=rcodes, z1row=z1row, z2row=z2row)

    # ---------------- one step for one sequence (vmapped over batch)
    def _seq_step(self, codes, n, pt, energy, active, rorder,
                  seen_h1, seen_h2, seen_cnt, done, cplx_dropped,
                  enum_suspect):
        cfg, dp = self.cfg, self.dp
        K, R, M, N, V = cfg.K, cfg.R, cfg.M, cfg.N, cfg.V

        def _cut_(stage, *vals):
            # profiling-only early return (None in production; see
            # _PROFILE_CUT above)
            if _PROFILE_CUT != stage:
                return None
            return (pt, energy + _live_mix(vals, done), active, rorder,
                    seen_h1, seen_h2, seen_cnt, done, cplx_dropped,
                    enum_suspect)

        keys = (_kmer_keys(codes, 5), _kmer_keys(codes, 6), _kmer_keys(codes, 8))

        lay = self.region_layout(codes, n, pt, rorder)
        loops = lay["loops"]
        c = _cut_("analyze", loops["enclose"], loops["mls"], loops["loop_e"],
                  loops["branches"], loops["exts"])
        if c is not None:
            return c
        rpos, rloc, rslot, mlen = (lay["rpos"], lay["rloc"], lay["rslot"],
                                   lay["mlen"])
        rcodes, z1row, z2row = lay["rcodes"], lay["z1row"], lay["z2row"]
        c = _cut_("regions", rpos, rloc, rslot, mlen, rcodes)
        if c is not None:
            return c

        cor, lags, lvals, lag_ok, ws = scan_tables(
            cfg, dp, self.W, rcodes, rpos, mlen, z1row, z2row,
            self.scan_path, active=active)
        c = _cut_("corr", lags, lvals, lag_ok)
        if c is not None:
            return c
        c = _cut_("wscan", ws["max_nb"], ws["max_i"], ws["max_j"],
                  ws["best_sE"])
        if c is not None:
            return c
        # assume_batched: the compacted [K,CC] shapes are below the
        # one-hot threshold at trace time, but the real index volume
        # (x batch) is far above it — force the fast formulation
        with assume_batched():
            delta, cplx, has, p0, q0, a, b2 = _candidate_delta(
                cfg, dp, codes, n, keys, pt, loops, rorder, rpos, mlen,
                ws, lags)
        c = _cut_("cdelta", delta, cplx, has, p0, q0, a, b2)
        if c is not None:
            return c

        # ---- complex candidates: full eval under budget
        flat_cplx = (cplx & lag_ok).reshape(-1)
        order_c = jnp.argsort(~flat_cplx)            # complex first
        c_idx = order_c[: cfg.CPLX]
        c_on = flat_cplx[c_idx]
        c = _cut_("cplx_sel", c_idx, c_on)
        if c is not None:
            return c

        ck = jnp.clip(c_idx // (R * M), 0, K - 1)
        cr = (c_idx // M) % R
        selr = jnp.arange(R, dtype=jnp.int32)[None, :] == cr[:, None]
        cflat = lambda f: f.reshape(K * R * M)[c_idx]       # [CPLX] (small)
        cand_pts = _combo_pt(
            cfg, row_lookup(pt, ck), row_lookup(rloc, ck),
            row_lookup(rslot, ck), row_lookup(rpos, ck),
            jnp.where(selr, cflat(ws["max_i"])[:, None], 0),
            jnp.where(selr, cflat(ws["max_j"])[:, None], 0),
            jnp.where(selr, cflat(ws["max_nb"])[:, None], 0),
            selr)
        c = _cut_("cplx_pt", cand_pts)
        if c is not None:
            return c
        with assume_batched():
            cand_E = jax.vmap(lambda p: eval_pt(dp, codes, p, n))(cand_pts)
        parent_E = row_lookup(energy, ck)
        c_delta = cand_E - parent_E
        delta_flat = delta.reshape(-1)
        delta_flat = delta_flat.at[c_idx].set(
            jnp.where(c_on, c_delta, delta_flat[c_idx]))
        delta = delta_flat.reshape(K, R, M)
        resolved = jnp.zeros((K * R * M,), bool).at[c_idx].set(c_on).reshape(K, R, M)
        dropped = (cplx & lag_ok & ~resolved).sum()
        c = _cut_("cplx", delta, resolved, dropped)
        if c is not None:
            return c

        # ---- acceptance (reference float32 semantics)
        e32 = jnp.float32(energy)[:, None, None]
        dnrj = (e32 + jnp.float32(delta)) / jnp.float32(100.0) \
            - e32 / jnp.float32(100.0)
        usable = has & lag_ok & (~cplx | resolved)
        accept = usable & (dnrj < jnp.float32(cfg.min_nrj))

        # ---- per-region candidate order: (dnrj asc, lag-rank asc)
        # The packed accumulator channels (consumed by the enumeration
        # below) ride the acceptance sort as payloads, so the
        # rank-permutation costs no separate [K,R,M,M] one-hot pass.
        OFF = jnp.int32(1 << 19)
        uv = lambda x: x.astype(jnp.uint32)
        iv = lambda x: x.astype(jnp.int32)
        lin_c = ws["max_j"] - ws["max_i"] - 1
        i0_c = ws["max_i"] - ws["max_nb"] + 1
        nlive2 = ((lin_c > 0).astype(jnp.int32)
                  + ((i0_c > 0) | (ws["max_j"] + ws["max_nb"]
                                   < mlen[..., None])).astype(jnp.int32))
        h1lo = iv(uv(ws["hd1"]) & 0xFFFF)
        h1hi = iv(uv(ws["hd1"]) >> 16)
        h2lo = iv(uv(ws["hd2"]) & 0xFFFF)
        h2hi = iv(uv(ws["hd2"]) >> 16)
        C0 = ((delta + OFF) + nlive2 * (1 << 21)).astype(jnp.float32)
        C1 = (h1lo + (h1hi & 0xFF) * (1 << 16)).astype(jnp.float32)
        C2 = (h2lo + (h2hi & 0xFF) * (1 << 16)).astype(jnp.float32)
        C3 = ((h1hi >> 8) + (h2hi >> 8) * (1 << 8)).astype(jnp.float32)

        sort_key = jnp.where(accept, dnrj, jnp.float32(3e38))
        iota_m = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32),
                                  (K, R, M))
        _, ordm, D0, D1, D2, D3 = jax.lax.sort(
            (sort_key, iota_m, C0, C1, C2, C3), dimension=-1, num_keys=1,
            is_stable=True)
        s_r = accept.sum(axis=-1).astype(jnp.int32)            # [K,R]
        c = _cut_("accept", ordm, s_r, accept, D0, D1, D2, D3)
        if c is not None:
            return c

        # ---- windowed combination enumeration
        # The reference walks EVERY parent's full candidate product,
        # adding each unseen combination to `seen` and counting new
        # structures toward the max_branch cap (rafft.py:178-203); the
        # post-cap quirk processes exactly the FIRST combo of each later
        # parent.  A single fixed window cannot reproduce that when the
        # product space is duplicate-heavy (the round-4/5 fallback
        # histograms put ~100% of CPU fallbacks on window truncation in
        # the 256+ buckets), so the combo space is walked in
        # lexicographic V-slabs under a lax.while_loop: the seen-set
        # insertion between windows makes cross-window dedup exact, a
        # running top-K beam of new structures carries forward, and the
        # loop exits at the cap (reference semantics, bit-exact) or
        # after exhausting the (clamped) products.  Only if W windows
        # were not enough does the sequence flag for the CPU fallback.
        part = (s_r > 0)
        sz = jnp.where(part, s_r, 1)
        CLAMP = jnp.int32(1 << 20)
        prod_k = jnp.ones((K,), jnp.int32)
        for r in range(R):
            prod_k = jnp.minimum(prod_k * sz[:, r], CLAMP)
        prod_k = jnp.where(part.any(axis=-1), prod_k, 0)
        participating = prod_k > 0
        Pk = jnp.cumsum(prod_k)                                # [K]
        first_start = Pk - prod_k                              # [K]
        total_combos = Pk[-1]

        ph1, ph2 = self._hash(pt)                              # [K] u32
        PH = jnp.stack([iv(ph1 & 0xFFFF), iv(ph1 >> 16),
                        iv(ph2 & 0xFFFF), iv(ph2 >> 16)], axis=-1)
        D4 = jnp.stack([D0, D1, D2, D3], axis=-1)              # [K,R,M,4]
        kk_i = jnp.arange(K, dtype=jnp.int32)
        v = jnp.arange(V, dtype=jnp.int32)
        INFE = jnp.int32(2**30)
        M_NORM, M_FIRST, M_DONE = jnp.int32(0), jnp.int32(1), jnp.int32(2)

        def _window(carry):
            (win, mode, base, nb, kcap, s_h1, s_h2, s_cnt,
             bm_valid, bm_E, bm_tie, bm_kv, bm_idx, bm_on, bm_h1, bm_h2,
             susr, suss, mism) = carry
            g = base + v
            kv = jnp.searchsorted(Pk, g, side="right").astype(jnp.int32)
            kvc = jnp.clip(kv, 0, K - 1)
            local = g - jnp.where(kv > 0,
                                  Pk[jnp.clip(kv - 1, 0, K - 1)], 0)
            v_ok = (g < total_combos) & ~done

            szk = row_lookup(sz, kvc)                          # [V,R]
            # stride_r = prod of sizes after r (last region varies
            # fastest); clamped iterative product — local < prod <=
            # CLAMP, and any clamped stride >= CLAMP > local divides to
            # 0, so the clamp is lossless
            stride_cols = []
            acc = jnp.ones((V,), jnp.int32)
            for r in range(R - 1, -1, -1):
                stride_cols.append(acc)
                acc = jnp.minimum(acc * szk[:, r], CLAMP)
            stride = jnp.stack(stride_cols[::-1], axis=-1)     # [V,R]
            idx_r = (local[:, None] // stride) % szk           # [V,R]
            on_r = row_lookup(part, kvc)                       # [V,R]

            # [V]-level pick of the packed per-candidate accumulators:
            # additive quantities only (dE, hash delta, live-region
            # count); the stems themselves are rebuilt post-pool for
            # survivors.  One one-hot contraction over K, one over the
            # (acceptance-sorted) rank axis.
            oh_k = (kvc[:, None] == kk_i).astype(jnp.float32)  # [V,K]
            Dv = jnp.einsum('vk,kx->vx', oh_k,
                            D4.reshape(K, R * M * 4),
                            precision=jax.lax.Precision.HIGHEST
                            ).reshape(V, R, M, 4)
            ohs = (idx_r[..., None] == jnp.arange(M, dtype=jnp.int32)
                   ).astype(jnp.float32)                       # [V,R,M]
            picked = jnp.einsum('vrs,vrsc->vrc', ohs, Dv,
                                precision=jax.lax.Precision.HIGHEST)
            pc = picked.astype(jnp.int32)                      # [V,R,4]
            d_nlive = pc[..., 0] >> 21
            d_delta = (pc[..., 0] & ((1 << 21) - 1)) - OFF
            d_h1 = iv((uv(pc[..., 1]) & 0xFFFF)
                      | ((uv(pc[..., 1]) >> 16) << 16)
                      | ((uv(pc[..., 3]) & 0xFF) << 24))
            d_h2 = iv((uv(pc[..., 2]) & 0xFFFF)
                      | (((uv(pc[..., 2]) >> 16) & 0xFF) << 16)
                      | ((uv(pc[..., 3]) >> 8) << 24))

            new_E = row_lookup(energy, kvc) \
                + jnp.where(on_r, d_delta, 0).sum(axis=-1)
            # a combo with more live regions than R slots would silently
            # drop regions; flag for the CPU-parity fallback
            r_over = jnp.where(on_r, d_nlive, 0).sum(axis=-1) > R

            # combination hashes compose additively from the parent's
            # hash + chosen stem deltas (uint32 mod 2^32) — exactly
            # _hash() of the combination pair table, never built
            phv = row_lookup(PH, kvc)                          # [V,4]
            hsum1 = jnp.where(on_r, d_h1, 0).astype(jnp.uint32).sum(-1)
            hsum2 = jnp.where(on_r, d_h2, 0).astype(jnp.uint32).sum(-1)
            h1 = (uv(phv[..., 0]) | (uv(phv[..., 1]) << 16)) + hsum1
            h2 = (uv(phv[..., 2]) | (uv(phv[..., 3]) << 16)) + hsum2

            if _CHECK_HASH:
                # debug/test mode: rebuild every combination pair table
                # the positional way, verify the composed hashes match
                cand_m = batched_taa(row_lookup(ordm, kvc),
                                     idx_r[..., None])[..., 0]
                ch_i_f = batched_taa(row_lookup(ws["max_i"], kvc),
                                     cand_m[..., None])[..., 0]
                ch_j_f = batched_taa(row_lookup(ws["max_j"], kvc),
                                     cand_m[..., None])[..., 0]
                ch_r_f = batched_taa(row_lookup(ws["max_nb"], kvc),
                                     cand_m[..., None])[..., 0]
                pt_full = _combo_pt(cfg, row_lookup(pt, kvc),
                                    row_lookup(rloc, kvc),
                                    row_lookup(rslot, kvc),
                                    row_lookup(rpos, kvc),
                                    ch_i_f, ch_j_f, ch_r_f, on_r)
                fh1, fh2 = self._hash(pt_full)
                mism = mism + (v_ok & ((fh1 != h1) | (fh2 != h2))).sum()

            # dedup within the window (cross-window dups are caught by
            # the seen-set, which every window's new structures entered)
            sc = jnp.arange(cfg.S) < s_cnt
            in_seen = ((h1[:, None] == s_h1[None, :])
                       & (h2[:, None] == s_h2[None, :])
                       & sc[None, :]).any(axis=-1)

            def first_occurrence(proc):
                ordh = jnp.lexsort((v, (~proc).astype(jnp.int32), h1, h2))
                h1s = h1[ordh]
                h2s = h2[ordh]
                first_s = jnp.concatenate([
                    jnp.array([True]),
                    (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1])])
                return jnp.zeros(V, bool).at[ordh].set(first_s) & proc

            # pass 1: locate the max_branch cap within this window (the
            # prefix is processed unconditionally, so dedup over the
            # full window is valid there)
            new1 = v_ok & first_occurrence(v_ok) & ~in_seen
            nb1 = nb + jnp.cumsum(new1.astype(jnp.int32))
            capped_now = nb1[-1] >= cfg.max_branch
            at_cap = new1 & (nb1 == cfg.max_branch)
            cap_v = jnp.where(capped_now,
                              jnp.argmax(at_cap).astype(jnp.int32),
                              jnp.int32(V))
            kcap_new = jnp.where(capped_now, kv[jnp.clip(cap_v, 0, V - 1)],
                                 kcap)

            # pass 2: the processed set (prefix + the post-cap
            # first-combo of every later parent that falls inside this
            # window — the reference's rafft.py:195-203 quirk),
            # re-deduplicated among itself
            processed = v_ok & jnp.where(
                capped_now,
                (v <= cap_v) | ((kv > kcap_new) & (local == 0)), True)
            newmask = first_occurrence(processed) & ~in_seen
            rank = jnp.cumsum(newmask.astype(jnp.int32)) - 1
            nb_out = nb + newmask.sum()

            susr = susr | (r_over & newmask).any()

            # insert into seen (capacity overflow voids dedup exactness)
            slot = jnp.where(newmask, s_cnt + rank, cfg.S - 1)
            s_h1 = s_h1.at[slot].set(jnp.where(newmask, h1, s_h1[slot]))
            s_h2 = s_h2.at[slot].set(jnp.where(newmask, h2, s_h2[slot]))
            s_cnt_new = s_cnt + newmask.sum()
            suss = suss | (s_cnt_new > cfg.S - 1)
            s_cnt = jnp.minimum(s_cnt_new, cfg.S - 1)

            # window top-K of new structures -> merge into running beam
            wE = jnp.where(newmask, new_E, INFE)
            ord_w = jnp.lexsort((v, wE))[: K]
            cat = lambda a, b: jnp.concatenate([a, b])
            E2 = cat(bm_E, wE[ord_w])
            tie2 = cat(bm_tie, g[ord_w])
            ord2 = jnp.lexsort((tie2, E2))[: K]
            bm_E = E2[ord2]
            bm_tie = tie2[ord2]
            bm_valid = cat(bm_valid, newmask[ord_w])[ord2]
            bm_kv = cat(bm_kv, kvc[ord_w])[ord2]
            bm_idx = cat(bm_idx, idx_r[ord_w])[ord2]
            bm_on = cat(bm_on, on_r[ord_w])[ord2]
            bm_h1 = cat(bm_h1, h1[ord_w])[ord2]
            bm_h2 = cat(bm_h2, h2[ord_w])[ord2]

            exhausted = base + V >= total_combos
            # M_FIRST = some later parent's first combo lies beyond this
            # window's end (in-window post-cap first-combos were fused
            # into the processed set above); handled by the [K]-wide
            # post-loop pass instead of a whole extra [V] window
            need_first = capped_now & (
                participating & (kk_i > kcap_new)
                & (first_start >= base + V)).any()
            mode = jnp.where(capped_now,
                             jnp.where(need_first, M_FIRST, M_DONE),
                             jnp.where(exhausted, M_DONE, M_NORM))
            base = jnp.where(mode == M_NORM, base + V, base)
            return (win + 1, mode, base, nb_out, kcap_new, s_h1, s_h2,
                    s_cnt, bm_valid, bm_E, bm_tie, bm_kv, bm_idx, bm_on,
                    bm_h1, bm_h2, susr, suss, mism)

        def _wcond(carry):
            win, mode = carry[0], carry[1]
            return (win < cfg.W) & (mode == M_NORM) & ~done

        init = (jnp.int32(0), M_NORM, jnp.int32(0), jnp.int32(0),
                jnp.int32(K), seen_h1, seen_h2, seen_cnt,
                jnp.zeros(K, bool), jnp.full(K, INFE), jnp.zeros(K, jnp.int32),
                jnp.zeros(K, jnp.int32), jnp.zeros((K, R), jnp.int32),
                jnp.zeros((K, R), bool), jnp.zeros(K, jnp.uint32),
                jnp.zeros(K, jnp.uint32), jnp.zeros((), bool),
                jnp.zeros((), bool), jnp.zeros((), jnp.int32))
        (wn, mode_f, _b, _nb, _kc, seen_h1, seen_h2, seen_cnt,
         bm_valid, bm_E, bm_tie, bm_kv, bm_idx, bm_on, bm_h1, bm_h2,
         susr, suss, mism_f) = jax.lax.while_loop(_wcond, _window, init)

        # ---- post-cap first combos beyond the last window: at most K-1
        # of them (rank-0 in every region), processed here at [K] width
        # instead of paying a whole [V] window for them
        f_ok = ((mode_f == M_FIRST) & participating & (kk_i > _kc)
                & (first_start >= _b + V) & ~done)
        pc0 = D4[:, :, 0, :].astype(jnp.int32)                 # [K,R,4]
        f_nlive = pc0[..., 0] >> 21
        f_delta = (pc0[..., 0] & ((1 << 21) - 1)) - OFF
        f_h1d = iv((uv(pc0[..., 1]) & 0xFFFF)
                   | ((uv(pc0[..., 1]) >> 16) << 16)
                   | ((uv(pc0[..., 3]) & 0xFF) << 24))
        f_h2d = iv((uv(pc0[..., 2]) & 0xFFFF)
                   | (((uv(pc0[..., 2]) >> 16) & 0xFF) << 16)
                   | ((uv(pc0[..., 3]) >> 8) << 24))
        fE = energy + jnp.where(part, f_delta, 0).sum(axis=-1)
        fh1 = ph1 + jnp.where(part, f_h1d, 0).astype(jnp.uint32).sum(-1)
        fh2 = ph2 + jnp.where(part, f_h2d, 0).astype(jnp.uint32).sum(-1)
        f_rover = jnp.where(part, f_nlive, 0).sum(axis=-1) > R
        fsc = jnp.arange(cfg.S) < seen_cnt
        f_inseen = ((fh1[:, None] == seen_h1[None, :])
                    & (fh2[:, None] == seen_h2[None, :])
                    & fsc[None, :]).any(axis=-1)
        ordf = jnp.lexsort((kk_i, (~f_ok).astype(jnp.int32), fh1, fh2))
        fh1s = fh1[ordf]
        fh2s = fh2[ordf]
        ffirst = jnp.concatenate([
            jnp.array([True]),
            (fh1s[1:] != fh1s[:-1]) | (fh2s[1:] != fh2s[:-1])])
        f_new = (jnp.zeros(K, bool).at[ordf].set(ffirst) & f_ok
                 & ~f_inseen)
        f_rank = jnp.cumsum(f_new.astype(jnp.int32)) - 1
        fslot = jnp.where(f_new, seen_cnt + f_rank, cfg.S - 1)
        seen_h1 = seen_h1.at[fslot].set(
            jnp.where(f_new, fh1, seen_h1[fslot]))
        seen_h2 = seen_h2.at[fslot].set(
            jnp.where(f_new, fh2, seen_h2[fslot]))
        f_cnt = seen_cnt + f_new.sum()
        suss = suss | (f_cnt > cfg.S - 1)
        seen_cnt = jnp.minimum(f_cnt, cfg.S - 1)
        susr = susr | (f_rover & f_new).any()
        fE_m = jnp.where(f_new, fE, INFE)
        E2f = jnp.concatenate([bm_E, fE_m])
        tie2f = jnp.concatenate([bm_tie, first_start])
        ord2f = jnp.lexsort((tie2f, E2f))[: K]
        bm_E = E2f[ord2f]
        bm_tie = tie2f[ord2f]
        bm_valid = jnp.concatenate([bm_valid, f_new])[ord2f]
        bm_kv = jnp.concatenate([bm_kv, kk_i])[ord2f]
        bm_idx = jnp.concatenate(
            [bm_idx, jnp.zeros((K, R), jnp.int32)])[ord2f]
        bm_on = jnp.concatenate([bm_on, jnp.broadcast_to(part, (K, R))]
                                )[ord2f]
        bm_h1 = jnp.concatenate([bm_h1, fh1])[ord2f]
        bm_h2 = jnp.concatenate([bm_h2, fh2])[ord2f]

        # exactness flags, one bit per cause so the sweep can histogram
        # WHICH budget tripped: v_window now only fires when W windows
        # could not reach the cap / exhaustion (was: any truncation)
        suspect_v = (mode_f == M_NORM) & ~done
        bits = (jnp.where(suspect_v, FLAG_VWINDOW, 0)
                | jnp.where(susr, FLAG_RSLOTS, 0)
                | jnp.where(suss, FLAG_SEEN, 0))
        if _CHECK_HASH:
            bits = bits | jnp.where(mism_f > 0, FLAG_HASH, 0)

        c = _cut_("enum", bm_E, bm_tie, bm_h1, bits)
        if c is not None:
            return c

        # ---- pool (new before old on ties) and truncate to K
        TBIG = jnp.int32(1 << 28)
        pool_E = jnp.concatenate([jnp.where(bm_valid, bm_E, INFE),
                                  jnp.where(active, energy, INFE)])
        tie = jnp.concatenate([bm_tie, TBIG + jnp.arange(K, dtype=jnp.int32)])
        order_p = jnp.lexsort((tie, pool_E))[: K]
        sel_new = order_p < K
        src_new = jnp.clip(order_p, 0, K - 1)
        src_old = jnp.clip(order_p - K, 0, K - 1)

        # ---- rebuild the K survivors' pair tables + child region order
        # (deferred from the [V] level: only pooled slots need them)
        kv_sel = bm_kv[src_new]                                # [K]
        idx_sel = bm_idx[src_new]                              # [K,R]
        on_sel = bm_on[src_new]
        cand_sel = batched_taa(row_lookup(ordm, kv_sel),
                               idx_sel[..., None])[..., 0]     # [K,R]

        def pick_s(field):
            return batched_taa(row_lookup(field, kv_sel),
                               cand_sel[..., None])[..., 0]

        chi_s = pick_s(ws["max_i"])
        chj_s = pick_s(ws["max_j"])
        chr_s = pick_s(ws["max_nb"])
        chp0_s = pick_s(p0)
        with assume_batched():
            new_pt_s = _combo_pt(
                cfg, row_lookup(pt, kv_sel), row_lookup(rloc, kv_sel),
                row_lookup(rslot, kv_sel), row_lookup(rpos, kv_sel),
                chi_s, chj_s, chr_s, on_sel)

        # child region order: per parent region -> [inner, outer]
        par_lab_s = row_lookup(rorder, kv_sel)                 # [K,R]
        mlen_s = row_lookup(mlen, kv_sel)
        inner_ok = on_sel & (chj_s - chi_s - 1 > 0)
        outer_ok = on_sel & (((chi_s - chr_s + 1) > 0)
                             | (chj_s + chr_s < mlen_s))
        lab2 = jnp.stack([jnp.where(inner_ok, chp0_s, -2),
                          jnp.where(outer_ok, par_lab_s, -2)], axis=-1)
        lab2 = lab2.reshape(K, 2 * R)
        key_order = jnp.where(lab2 > -2,
                              jnp.arange(2 * R, dtype=jnp.int32)[None, :],
                              jnp.int32(2 * R + 1))
        take = jnp.argsort(key_order, axis=-1)[:, :R]
        new_ror_s = batched_taa(lab2, take)

        beam_pt = jnp.where(sel_new[:, None], new_pt_s, pt[src_old])
        beam_E = jnp.where(sel_new, bm_E[src_new], energy[src_old])
        beam_act = jnp.where(sel_new, bm_valid[src_new], active[src_old])
        beam_ror = jnp.where(sel_new[:, None], new_ror_s,
                             rorder[src_old])

        # fixed-point check on composed hashes (== _hash of the tables)
        bh1 = jnp.where(sel_new, bm_h1[src_new], ph1[src_old])
        unchanged = jnp.all((bh1 == ph1) & (beam_act == active)
                            | (~beam_act & ~active))
        new_done = done | unchanged
        c = _cut_("pool", beam_pt, beam_E, beam_ror, bh1)
        if c is not None:
            return c

        keep = ~done
        pt = jnp.where(keep, beam_pt, pt)
        energy = jnp.where(keep, beam_E, energy)
        active = jnp.where(keep, beam_act, active)
        rorder = jnp.where(keep, beam_ror, rorder)
        cplx_dropped = cplx_dropped + jnp.where(keep, dropped, 0)
        enum_suspect = enum_suspect | jnp.where(keep, bits, 0)

        return (pt, energy, active, rorder, seen_h1, seen_h2, seen_cnt,
                new_done, cplx_dropped, enum_suspect)

    def _swap_impl(self, st):
        """Device-side continuous batching: lanes whose fold finished (or
        hit the step safety limit) bank their result into the per-lane
        output buffer and restart on their shadow sequence — no host
        round-trip.  A lane whose output buffer is still full waits for
        the next host drain."""
        LIM = 2 * self.cfg.max_steps
        fin = (st["done"] | (st["lane_steps"] >= LIM)) & (st["seqid"] >= 0)
        rec = fin & st["next_avail"] & ~st["out_valid"]
        m1 = rec[:, None]
        m2 = rec[:, None, None]
        st = dict(st)
        st["out_pt"] = jnp.where(m2, st["pt"], st["out_pt"])
        st["out_E"] = jnp.where(m1, st["energy"], st["out_E"])
        st["out_act"] = jnp.where(m1, st["active"], st["out_act"])
        st["out_n"] = jnp.where(rec, st["n"], st["out_n"])
        st["out_seqid"] = jnp.where(rec, st["seqid"], st["out_seqid"])
        st["out_done"] = jnp.where(rec, st["done"], st["out_done"])
        st["out_flag"] = jnp.where(
            rec, st["enum_suspect"]
            | jnp.where(st["cplx_dropped"] > 0, FLAG_CPLX, 0)
            | jnp.where(st["done"], 0, FLAG_STEPLIM), st["out_flag"])
        st["out_valid"] = st["out_valid"] | rec
        st2 = self._refill_impl(st, rec, st["next_codes"], st["next_n"])
        st2["seqid"] = jnp.where(rec, st["next_seqid"], st["seqid"])
        st2["next_avail"] = st["next_avail"] & ~rec
        st2["lane_steps"] = jnp.where(rec, 0, st["lane_steps"])
        return st2

    def _runnable(self, st):
        LIM = 2 * self.cfg.max_steps
        fin = st["done"] | (st["lane_steps"] >= LIM)
        swappable = fin & st["next_avail"] & ~st["out_valid"]
        return ((st["seqid"] >= 0) & ~fin) | swappable

    def _advance_impl(self, state, G: int):
        """Up to G swap+step rounds in one device program (early exit
        when no lane can make progress), then a final swap so folds that
        finished on the last step are visible in the output buffers."""
        def cond(c):
            it, st = c
            return (it < G) & self._runnable(st).any()

        def body(c):
            it, st = c
            st = self._swap_impl(st)
            st = self._step_impl(st)
            st = dict(st)
            st["lane_steps"] = st["lane_steps"] + jnp.where(
                st["done"], 0, 1)
            return it + 1, st

        _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
        return self._swap_impl(st)

    def _drain_load_impl(self, state, clear, load, codes_new, n_new,
                         sid_new):
        st = dict(state)
        st["out_valid"] = st["out_valid"] & ~clear
        st["next_codes"] = jnp.where(load[:, None], codes_new,
                                     st["next_codes"])
        st["next_n"] = jnp.where(load, n_new, st["next_n"])
        st["next_seqid"] = jnp.where(load, sid_new, st["next_seqid"])
        st["next_avail"] = st["next_avail"] | load
        return st

    _OUT_KEYS = ("out_pt", "out_E", "out_act", "out_n", "out_seqid",
                 "out_done", "out_flag", "out_valid", "done", "seqid",
                 "lane_steps")

    def run_stream(self, seqs, G: int = 4, shard=None):
        """Continuous-batching fold over a sequence list.

        Yields (index, rows, flagged) as folds finish, where rows is the
        final beam [(dot_bracket, energy_kcal)] best-first.  The chip
        swaps finished lanes onto preloaded shadow sequences inside one
        device program (G steps per launch); the host only drains banked
        results and reloads shadows — ~2 round-trips per G steps instead
        of one per step.  `shard` optionally places the state on a mesh
        (parallel/mesh.shard_state)."""
        cfg, B = self.cfg, self.B
        nseq = len(seqs)
        state = self.init_state(seqs[:B], seqids=list(range(min(B, nseq))))
        if shard is not None:
            state = shard(state)
        nxt = min(B, nseq)
        # preload one shadow per lane
        load = np.zeros(B, bool)
        codes_new = np.zeros((B, cfg.N), np.int32)
        n_new = np.zeros(B, np.int32)
        sid_new = np.full(B, -1, np.int32)
        for b in range(B):
            if nxt < nseq:
                c = encode_sequence(seqs[nxt])
                codes_new[b, : len(c)] = c
                n_new[b] = len(c)
                sid_new[b] = nxt
                load[b] = True
                nxt += 1
        state = self._drain_load(state, jnp.zeros(B, bool),
                                 jnp.asarray(load), jnp.asarray(codes_new),
                                 jnp.asarray(n_new), jnp.asarray(sid_new))

        emitted = 0
        while emitted < nseq:
            state = self._advance(state, G)
            out = jax.device_get(tuple(state[k] for k in self._OUT_KEYS))
            (o_pt, o_E, o_act, o_n, o_sid, o_done, o_flag, o_valid,
             l_done, l_sid, l_steps) = out
            fresh = np.where(o_valid)[0]
            clear = np.zeros(B, bool)
            load = np.zeros(B, bool)
            codes_new = np.zeros((B, cfg.N), np.int32)
            n_new = np.zeros(B, np.int32)
            sid_new = np.full(B, -1, np.int32)
            for b in fresh:
                rows = self._rows_from(o_pt[b], o_E[b], o_act[b], o_n[b])
                # `flagged` is a cause bitmask (FLAG_*); truthy iff any
                # exactness budget tripped
                yield int(o_sid[b]), rows, int(o_flag[b]) | (
                    0 if o_done[b] else FLAG_STEPLIM)
                emitted += 1
                clear[b] = True
                if nxt < nseq:
                    c = encode_sequence(seqs[nxt])
                    codes_new[b, : len(c)] = c
                    n_new[b] = len(c)
                    sid_new[b] = nxt
                    load[b] = True
                    nxt += 1
            if clear.any() or load.any():
                state = self._drain_load(
                    state, jnp.asarray(clear), jnp.asarray(load),
                    jnp.asarray(codes_new), jnp.asarray(n_new),
                    jnp.asarray(sid_new))
            elif len(fresh) == 0:
                # end-game: no banked results and no shadows left —
                # remaining folds finish in live lanes
                LIM = 2 * cfg.max_steps
                live = (l_sid >= 0) & (l_done | (l_steps >= LIM))
                if not live.any():
                    continue
                pt_l, E_l, act_l, n_l, cd_l, es_l = jax.device_get(
                    (state["pt"], state["energy"], state["active"],
                     state["n"], state["cplx_dropped"],
                     state["enum_suspect"]))
                kill = np.zeros(B, bool)
                for b in np.where(live)[0]:
                    rows = self._rows_from(pt_l[b], E_l[b], act_l[b],
                                           n_l[b])
                    yield (int(l_sid[b]), rows,
                           int(es_l[b])
                           | (FLAG_CPLX if cd_l[b] > 0 else 0)
                           | (0 if l_done[b] else FLAG_STEPLIM))
                    emitted += 1
                    kill[b] = True
                # retire emitted lanes (seqid := -1 via a masked load of
                # an empty sequence)
                state = self._refill(state, jnp.asarray(kill),
                                     jnp.zeros((B, cfg.N), jnp.int32),
                                     jnp.zeros(B, jnp.int32))
                state = dict(state)
                state["seqid"] = jnp.where(jnp.asarray(kill), -1,
                                           state["seqid"])

    def _rows_from(self, pt_k, E_k, act_k, n_b):
        from rafft_tpu.struct import dot_bracket

        rows = []
        for k in range(self.cfg.K):
            if not act_k[k]:
                continue
            pairs = [(i, int(pt_k[k, i])) for i in range(n_b)
                     if pt_k[k, i] > i]
            db = dot_bracket(pairs, int(n_b))
            rows.append((db, float(np.float32(int(E_k[k]) / 100.0))))
        return rows

    def _steps_impl(self, state, max_iters: int):
        """Up to max_iters fold steps in ONE device program (early exit
        when the whole batch is done), so per-step polling costs no host
        round trip."""
        def cond(c):
            it, st = c
            return (it < max_iters) & ~st["done"].all()

        def body(c):
            it, st = c
            return it + 1, self._step_impl(st)

        _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
        return st

    def _step_impl(self, state):
        out = jax.vmap(self._seq_step)(
            state["codes"], state["n"], state["pt"], state["energy"],
            state["active"], state["rorder"], state["seen_h1"],
            state["seen_h2"], state["seen_cnt"], state["done"],
            state["cplx_dropped"], state["enum_suspect"])
        (pt, energy, active, rorder, sh1, sh2, scnt, done, cd, es) = out
        st = dict(state)
        st.update(pt=pt, energy=energy, active=active, rorder=rorder,
                  seen_h1=sh1, seen_h2=sh2, seen_cnt=scnt, done=done,
                  cplx_dropped=cd, enum_suspect=es)
        return st

    # ---------------- host API
    def run(self, seqs, collect_traj=False):
        state = self.init_state(seqs)
        if not collect_traj:
            # whole fold in one device program (no host round trip per
            # step)
            state = self._steps(state, self.cfg.max_steps)
            return self._beams(state, len(seqs)), state
        traj = []
        for _ in range(self.cfg.max_steps):
            if bool(np.asarray(state["done"]).all()):
                break
            traj.append(self._beams(state, len(seqs)))
            state = self._step(state)
        beams = self._beams(state, len(seqs))
        return beams, traj, state

    def _beams(self, state, nseq):
        from rafft_tpu.struct import dot_bracket

        pt = np.asarray(state["pt"])
        E = np.asarray(state["energy"])
        act = np.asarray(state["active"])
        n = np.asarray(state["n"])
        out = []
        for b in range(nseq):
            rows = []
            for k in range(self.cfg.K):
                if not act[b, k]:
                    continue
                pairs = [(i, int(pt[b, k, i])) for i in range(n[b])
                         if pt[b, k, i] > i]
                db = dot_bracket(pairs, int(n[b]))
                rows.append((db, float(np.float32(int(E[b, k]) / 100.0))))
            out.append(rows)
        return out


def fold_one(sequence, nb_mode=100, max_stack=1, max_branch=100, min_hp=3,
             min_nrj=0.0, traj=False, temp=37.0, gc_wei=3.0, au_wei=2.0,
             gu_wei=1.0):
    """Single-sequence convenience API on the batched engine (reference
    fold() signature)."""
    from rafft_tpu.struct import Structure

    N = 1 << max(5, int(np.ceil(np.log2(max(8, len(sequence))))))
    cfg = EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                       max_branch=max_branch,
                       min_hp=min_hp, min_nrj=min_nrj, temp=temp,
                       gc_wei=gc_wei, au_wei=au_wei, gu_wei=gu_wei,
                       V=min(4096, max(256, 2 * max_branch)),
                       S=max(4096, 16 * max_stack * 8),
                       R=16 if N <= 512 else 32)
    eng = FoldEngine(cfg, B=1)
    if traj:
        beams, steps, _ = eng.run([sequence], collect_traj=True)
        mk = lambda rows: [Structure([], [], e, db) for db, e in rows]
        return mk(beams[0]), [mk(s[0]) for s in steps]
    beams, _ = eng.run([sequence])
    return [Structure([], [], e, db) for db, e in beams[0]]
