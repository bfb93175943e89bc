"""Batched MFE (Zuker) folding on the device — anti-diagonal wavefront DP.

Device replacement for the reference's ViennaRNA `RNA.fold` baseline
(/root/reference/benchmark_results/src/vrna_mfe.py:24) at sweep scale:
the O(N^3) Zuker recursion is laid out as a `lax.scan` over the N
anti-diagonals, each step doing fully-vectorised [P,N] interior-loop
minimisation (P = all (a,b) loop-size offsets with a+b <= MAXLOOP+2) and
[N,N] skew-gather min-plus reductions for the multiloop splits, vmapped
over the sequence batch.  Same integer dekacal tables as the native C++
backend (rafft_tpu/native/turner_eval.cpp) — energies are bit-equal.

Matrices use diagonal indexing: Cd[d, i] = C(i, i+d), Md[d, i] =
fML(i, i+d).  Traceback runs on host from the device-filled matrices.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

import rafft_tpu.jax_setup  # noqa: F401
from rafft_tpu.energy.params import get_params, encode_sequence
from rafft_tpu.energy.eval_jax import (device_params, _ptype, _g, _sget,
                                       _hairpin, _int_loop, _ml_stem,
                                       _ext_stem, _kmer_keys)

INF = np.int32(1 << 28)
MAXLOOP = 30


def _ab_pairs():
    """All interior-loop offsets (a, b): inner pair (i+a, j-b) with
    unpaired sizes (a-1) + (b-1) <= MAXLOOP."""
    ab = [(a, b) for a in range(1, MAXLOOP + 2)
          for b in range(1, MAXLOOP + 2) if (a - 1) + (b - 1) <= MAXLOOP]
    arr = np.array(ab, dtype=np.int32)
    return arr[:, 0], arr[:, 1]


_A_VEC, _B_VEC = _ab_pairs()


def _skew_min(Md, d, shift):
    """min over t of fML(i+shift, i+shift+t) + fML(i+shift+t+1, i+d-shift)
    — the multiloop split reduction, as one flat gather + row-min.

    shift=0: fML(i,u)+fML(u+1,j) for the fML recurrence; shift=1:
    fML(i+1,u)+fML(u+1,j-1) for the closing-pair decomposition."""
    N = Md.shape[0]
    ii = jnp.arange(N, dtype=jnp.int32)
    tt = jnp.arange(N, dtype=jnp.int32)
    Mflat = Md.reshape(-1)

    # first segment: Md[t, i+shift]
    c1 = ii[None, :] + shift
    idx1 = tt[:, None] * N + jnp.clip(c1, 0, N - 1)
    v1 = jnp.where((tt[:, None] >= 4) & (c1 < N), Mflat[idx1], INF)

    # second segment: Md[d2, i+shift+t+1], d2 = d - 2*shift - 1 - t
    d2 = d - 2 * shift - 1 - tt
    c2 = ii[None, :] + tt[:, None] + 1 + shift
    idx2 = jnp.clip(d2, 0, N - 1)[:, None] * N + jnp.clip(c2, 0, N - 1)
    v2 = jnp.where((d2[:, None] >= 4) & (c2 < N), Mflat[idx2], INF)

    return jnp.min(jnp.where(v1 + v2 < INF, v1 + v2, INF), axis=0)


@partial(jax.jit, static_argnames=("with_f",))
def _mfe_fill(dp_dict, codes, n, with_f=True):
    """Fill Cd/Md (and F) for a batch: codes [B,N] int32, n [B] int32."""
    dp = _DpView(dp_dict)

    def one(codes, n):
        return _mfe_fill_one(dp, codes, n, with_f)

    return jax.vmap(one)(codes, n)


class _DpView:
    def __init__(self, d):
        self.__dict__.update(d)


def _dp_dict(temperature, max_len):
    dp = device_params(temperature, max_len=max_len)
    return dict(dp.__dict__)


def _mfe_fill_one(dp, codes, n, with_f):
    N = codes.shape[0]
    ii = jnp.arange(N, dtype=jnp.int32)
    key5 = _kmer_keys(codes, 5)
    key6 = _kmer_keys(codes, 6)
    key8 = _kmer_keys(codes, 8)
    a_vec = jnp.asarray(_A_VEC)
    b_vec = jnp.asarray(_B_VEC)

    can = _g(dp.pair_type, codes[:, None], codes[None, :]) > 0  # [N,N]

    def body(carry, d):
        Cd, Md = carry
        j = ii + d
        valid = (j < n)
        canij = jnp.where(valid & (j < N),
                          can.reshape(-1)[ii * N + jnp.clip(j, 0, N - 1)],
                          False) & (d >= 4)

        # ---- C(i, i+d)
        hp = _hairpin(dp, codes, n, ii, jnp.clip(j, 0, N - 1),
                      key5, key6, key8)

        q = ii[None, :] + a_vec[:, None]                 # [P,N]
        r = j[None, :] - b_vec[:, None]
        dprime = d - a_vec - b_vec                       # [P]
        Cflat = Cd.reshape(-1)
        cin_idx = (jnp.clip(dprime, 0, N - 1)[:, None] * N
                   + jnp.clip(q, 0, N - 1))
        cin = jnp.where((dprime[:, None] >= 4) & (q < N), Cflat[cin_idx], INF)
        il = _int_loop(dp, codes, n, ii[None, :], jnp.clip(j, 0, N - 1)[None, :],
                       jnp.clip(q, 0, N - 1), jnp.clip(r, 0, N - 1))
        il_tot = jnp.where(cin < INF, il + cin, INF)
        best_il = jnp.min(il_tot, axis=0)                # [N]

        mlsplit = _skew_min(Md, d, shift=1)              # [N]
        tclose = _ptype(dp, _sget(codes, j, n), codes)
        mlstem_close = _ml_stem(dp, tclose, _sget(codes, j - 1, n),
                                _sget(codes, ii + 1, n))
        best_ml = jnp.where(mlsplit < INF,
                            dp.ml_closing + mlstem_close + mlsplit, INF)

        cnew = jnp.minimum(jnp.minimum(hp, best_il), best_ml)
        cnew = jnp.where(canij, cnew, INF)
        Cd = jax.lax.dynamic_update_index_in_dim(Cd, cnew, d, axis=0)

        # ---- fML(i, i+d)
        dm1 = jnp.clip(d - 1, 0, N - 1)
        # fML(i+1, j): diagonal d-1, column i+1
        m_left = jnp.where(
            (ii + 1 < N), Md.reshape(-1)[dm1 * N + jnp.clip(ii + 1, 0, N - 1)],
            INF)
        m_left = jnp.where(m_left < INF, m_left + dp.ml_base, INF)
        m_right = Md[dm1]
        m_right = jnp.where(m_right < INF, m_right + dp.ml_base, INF)
        tij = _ptype(dp, codes, _sget(codes, j, n))
        stem = jnp.where(cnew < INF,
                         cnew + _ml_stem(dp, tij, _sget(codes, ii - 1, n),
                                         _sget(codes, j + 1, n)),
                         INF)
        msplit = _skew_min(Md, d, shift=0)
        mnew = jnp.minimum(jnp.minimum(m_left, m_right),
                           jnp.minimum(stem, msplit))
        mnew = jnp.where(valid & (d >= 4), mnew, INF)
        Md = jax.lax.dynamic_update_index_in_dim(Md, mnew, d, axis=0)
        return (Cd, Md), None

    Cd0 = jnp.full((N, N), INF, dtype=jnp.int32)
    Md0 = jnp.full((N, N), INF, dtype=jnp.int32)
    (Cd, Md), _ = jax.lax.scan(body, (Cd0, Md0), jnp.arange(N, dtype=jnp.int32))

    if not with_f:
        return Cd, Md

    # ---- exterior F: F[k] = MFE of prefix of length k
    ext_all = _ext_stem(dp, codes, n, ii[:, None], ii[None, :])  # [N,N] (i,j)

    def fbody(F, j):
        cj = Cd.reshape(-1)[jnp.clip(j - ii, 0, N - 1) * N + ii]   # C(i,j)
        ok = (ii <= j - 4) & (j < n) & (cj < INF)
        cand = jnp.where(
            ok, F[jnp.clip(ii, 0, N)] + cj
            + ext_all.reshape(-1)[ii * N + jnp.clip(j, 0, N - 1)],
            INF)
        best = jnp.minimum(F[jnp.clip(j, 0, N)], jnp.min(cand))
        F = jax.lax.dynamic_update_index_in_dim(
            F, jnp.where(j < n, best, F[jnp.clip(j, 0, N)]), j + 1, axis=0)
        return F, None

    F0 = jnp.zeros(N + 1, dtype=jnp.int32)
    F, _ = jax.lax.scan(fbody, F0, jnp.arange(N, dtype=jnp.int32))
    energy = F[jnp.clip(n, 0, N)]
    return Cd, Md, F, energy


# ======================================================================
# host-side traceback (numpy, reads the device-filled matrices)
# ======================================================================

def _traceback(seq, Cd, Md, F, params):
    from rafft_tpu.energy.eval_np import (_hairpin as np_hp,
                                          _int_loop as np_il,
                                          _ml_stem as np_mls,
                                          _ext_stem as np_ext,
                                          _ptype as np_pt)

    s = encode_sequence(seq)
    useq = seq.upper().replace("T", "U")
    n = len(seq)
    N = Cd.shape[0]
    INFV = int(INF)

    def C(i, j):
        return int(Cd[j - i, i]) if 0 <= j - i < N else INFV

    def M(i, j):
        return int(Md[j - i, i]) if 0 <= j - i < N else INFV

    def mlstem(i, j):
        return np_mls(s, n, np_pt(s, i, j), i - 1, j + 1, params)

    pt = np.full(n, -1, dtype=np.int32)
    stk = [(0, 0, n - 1)]
    while stk:
        kind, i, j = stk.pop()
        if kind == 0:  # exterior [0..j]
            jj = j
            while jj >= 4:
                if F[jj + 1] == F[jj]:
                    jj -= 1
                    continue
                hit = False
                for i2 in range(0, jj - 3):
                    cc = C(i2, jj)
                    if cc >= INFV:
                        continue
                    if (F[i2] if i2 > 0 else 0) + cc + np_ext(
                            s, n, i2, jj, params) == F[jj + 1]:
                        pt[i2], pt[jj] = jj, i2
                        stk.append((1, i2, jj))
                        jj = i2 - 1
                        hit = True
                        break
                if not hit:
                    jj -= 1
        elif kind == 1:  # C(i,j)
            target = C(i, j)
            if target == np_hp(s, useq, i, j, params):
                continue
            hit = False
            for p in range(i + 1, min(i + MAXLOOP + 1, j - 5) + 1):
                qmin = max(p + 4, j - 1 - (MAXLOOP - (p - i - 1)))
                for q in range(j - 1, qmin - 1, -1):
                    cc = C(p, q)
                    if cc >= INFV:
                        continue
                    if np_il(s, i, j, p, q, params) + cc == target:
                        pt[p], pt[q] = q, p
                        stk.append((1, p, q))
                        hit = True
                        break
                if hit:
                    break
            if hit:
                continue
            base = (params.ml_closing
                    + np_mls(s, n, np_pt(s, j, i), j - 1, i + 1, params))
            for u in range(i + 5, j - 5):
                if M(i + 1, u) + M(u + 1, j - 1) + base == target:
                    stk.append((2, i + 1, u))
                    stk.append((2, u + 1, j - 1))
                    break
        else:  # fML segment
            ii_, jj_ = i, j
            while ii_ < jj_:
                target = M(ii_, jj_)
                if target >= INFV:
                    break
                if M(ii_ + 1, jj_) + params.ml_base == target:
                    ii_ += 1
                    continue
                if M(ii_, jj_ - 1) + params.ml_base == target:
                    jj_ -= 1
                    continue
                if C(ii_, jj_) < INFV and \
                        C(ii_, jj_) + mlstem(ii_, jj_) == target:
                    pt[ii_], pt[jj_] = jj_, ii_
                    stk.append((1, ii_, jj_))
                    break
                done = False
                for u in range(ii_ + 4, jj_ - 4):
                    if M(ii_, u) + M(u + 1, jj_) == target:
                        stk.append((2, ii_, u))
                        ii_ = u + 1
                        done = True
                        break
                if not done:
                    break
    return pt


class MfeEngine:
    """Compiled batched MFE engine for one (N, temperature) pair."""

    def __init__(self, N: int, temperature: float = 37.0, B: int = 8):
        self.N = N
        self.B = B
        self.temperature = temperature
        self.dpd = _dp_dict(temperature, N)
        self.params = get_params(temperature)

    def fold(self, seqs, structures=True):
        """Returns list of (dot_bracket|None, energy_kcal) per sequence."""
        from rafft_tpu.struct import dot_bracket

        B, N = self.B, self.N
        assert len(seqs) <= B
        codes = np.zeros((B, N), np.int32)
        n = np.zeros(B, np.int32)
        for b, s in enumerate(seqs):
            c = encode_sequence(s)
            assert len(c) <= N
            codes[b, : len(c)] = c
            n[b] = len(c)
        Cd, Md, F, E = _mfe_fill(self.dpd, jnp.asarray(codes), jnp.asarray(n))
        Cd, Md, F, E = (np.asarray(Cd), np.asarray(Md), np.asarray(F),
                        np.asarray(E))
        out = []
        for b, seq in enumerate(seqs):
            e = float(E[b]) / 100.0
            if not structures:
                out.append((None, e))
                continue
            pt = _traceback(seq, Cd[b], Md[b], F[b], self.params)
            pairs = [(i, int(j)) for i, j in enumerate(pt) if j > i]
            out.append((dot_bracket(pairs, len(seq)), e))
        return out


def mfe_batch(seqs, temperature: float = 37.0, N: int | None = None):
    """One-shot batched MFE over a list of sequences."""
    if N is None:
        N = 1 << max(5, int(np.ceil(np.log2(max(len(s) for s in seqs)))))
    eng = MfeEngine(N, temperature, B=len(seqs))
    return eng.fold(seqs)
