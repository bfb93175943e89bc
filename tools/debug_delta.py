"""Cross-check the batched engine's incremental candidate dE against the
exact oracle, for one parent structure (eager mode, CPU backend).

Usage: JAX_PLATFORMS=cpu python tools/debug_delta.py <seq> <parent_db>
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.energy.eval_np import eval_structure_int
from rafft_tpu.energy.eval_jax import analyze_pt, _kmer_keys
from rafft_tpu.energy.params import encode_sequence
from rafft_tpu.struct import pair_table, dot_bracket, paired_positions


def candidates_for(seq, parent_db, nb_mode=100, K=1):
    import jax as _jax
    return _candidates_impl(seq, parent_db, nb_mode, K)


def _candidates_impl(seq, parent_db, nb_mode, K):
    n = len(seq)
    N = 1 << max(5, int(np.ceil(np.log2(max(8, n)))))
    cfg = FJ.EngineConfig(N=N, K=K, M=nb_mode, R=16, V=64, S=256)
    eng = FJ.FoldEngine(cfg, B=1)
    dp = eng.dp

    codes = np.zeros(N, np.int32)
    codes[:n] = encode_sequence(seq)
    codes = jnp.asarray(codes)
    nn = jnp.int32(n)

    ptv = np.full(N, -1, np.int32)
    pt0 = pair_table(parent_db)
    ptv[:n] = pt0
    pt = jnp.asarray(np.broadcast_to(ptv, (K, N)).copy())
    energy = jnp.asarray([eval_structure_int(seq, parent_db)] * K, jnp.int32)
    active = jnp.asarray([True] * K)

    # region order: loops with unpaired, reference-order unknown for a
    # hand-built parent — use exterior first then openings ascending
    import jax
    loops = jax.vmap(lambda p: analyze_pt(dp, codes, p, nn))(pt)
    enclose = np.asarray(loops["enclose"][0])
    labs = []
    for x in range(n):
        if pt0[x] == -1:
            lb = enclose[x]
            if lb not in labs:
                labs.append(int(lb))
    ror = np.full((K, cfg.R), -2, np.int32)
    ror[0, :len(labs)] = labs
    rorder = jnp.asarray(ror)

    import jax

    @jax.jit
    def pipeline(codes, nn, pt, rorder, active):
        keys = (_kmer_keys(codes, 5), _kmer_keys(codes, 6), _kmer_keys(codes, 8))
        loops_ = jax.vmap(lambda p: analyze_pt(dp, codes, p, nn))(pt)
        rpos, rloc, rslot, mlen = FJ._regions(cfg, pt, loops_["enclose"],
                                              rorder, nn)
        rcodes = jnp.where(rpos < N, codes[jnp.clip(rpos, 0, N - 1)], 0)
        cor = FJ._correlate(cfg, eng.W, rcodes, mlen, eng.integral)
        lags, lvals = FJ._top_lags(cfg, cor)
        lag_ok = (lvals > FJ.NEG / 2) & (mlen[:, :, None] >= 2) \
            & active[:, None, None]
        ws = FJ._window_scan(cfg, dp, eng.W, rcodes, rpos, mlen, lags, lag_ok)
        delta, unsup, has, p0, q0, a, b2 = FJ._candidate_delta(
            cfg, dp, codes, nn, keys, pt, loops_, rorder, rpos, mlen, ws, lags)
        return dict(rpos=rpos, rloc=rloc, rslot=rslot, mlen=mlen,
                    lag_ok=lag_ok, ws=ws, delta=delta, unsup=unsup)

    out_d = pipeline(codes, nn, pt, rorder, active)
    rpos, rloc, rslot, mlen = (out_d["rpos"], out_d["rloc"], out_d["rslot"],
                               out_d["mlen"])
    lag_ok = out_d["lag_ok"]
    ws = out_d["ws"]
    delta = out_d["delta"]
    unsup = out_d["unsup"]

    out = []
    R, M = cfg.R, cfg.M
    for r in range(R):
        for m in range(M):
            if not bool(np.asarray(lag_ok)[0, r, m]):
                continue
            run = int(np.asarray(ws["max_nb"])[0, r, m])
            if run == 0:
                continue
            # build candidate pt
            cand = FJ._combo_pt(
                cfg, pt[0], rloc[0], rslot[0], rpos[0],
                jnp.where(jnp.arange(R) == r, ws["max_i"][0, r, m], 0),
                jnp.where(jnp.arange(R) == r, ws["max_j"][0, r, m], 0),
                jnp.where(jnp.arange(R) == r, ws["max_nb"][0, r, m], 0),
                jnp.arange(R) == r)
            cand = np.asarray(cand)[:n]
            pairs = [(i, int(cand[i])) for i in range(n) if cand[i] > i]
            db = dot_bracket(pairs, n)
            true_d = eval_structure_int(seq, db) - int(np.asarray(energy)[0])
            eng_d = int(np.asarray(delta)[0, r, m])
            out.append(dict(r=r, m=m, run=run, db=db, true=true_d,
                            eng=eng_d,
                            unsup=bool(np.asarray(unsup)[0, r, m]),
                            ok=(true_d == eng_d)))
    return out


if __name__ == "__main__":
    seq = sys.argv[1]
    parent = sys.argv[2]
    rows = candidates_for(seq, parent)
    bad = [r for r in rows if not r["ok"] and not r["unsup"]]
    print(f"{len(rows)} candidates, {len(bad)} wrong fast-path deltas, "
          f"{sum(r['unsup'] for r in rows)} unsupported")
    for r in bad[:10]:
        print(f"r={r['r']} m={r['m']} run={r['run']} true={r['true']} "
              f"eng={r['eng']}")
        print("   ", r["db"])
