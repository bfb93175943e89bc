"""Dump batched-engine candidate internals for one parent structure."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import csv
import numpy as np
import jax, jax.numpy as jnp

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig

CORPUS = "/root/reference/benchmark_results/benchmark_cleaned_all_length.csv"
seqs = []
with open(CORPUS) as fh:
    for row in csv.reader(fh):
        if len(row) >= 3 and len(row[0]) <= 120:
            seqs.append(row[0])
seq = seqs[7]
PARENT = '..............((((..........................................................))))......................'

cfg = EngineConfig(N=128, K=50, R=16, M=100, V=4096, S=16384, max_branch=1000)
eng = FoldEngine(cfg, B=1)
state = eng.init_state([seq])
state = eng._step(state)
beams = eng._beams(state, 1)[0]
kidx = [k for k, (db, e) in enumerate(beams) if db == PARENT]
print("parent k =", kidx, beams[kidx[0]] if kidx else None)
k = kidx[0]

dp = eng.dp
codes = state["codes"][0]
n = state["n"][0]
pt = state["pt"][0]
energy = state["energy"][0]
rorder = state["rorder"][0]

keys = (FJ._kmer_keys(codes, 5), FJ._kmer_keys(codes, 6), FJ._kmer_keys(codes, 8))
loops = jax.vmap(lambda p: FJ.analyze_pt(dp, codes, p, n))(pt)
rpos, rloc, rslot, mlen = FJ._regions(cfg, pt, loops["enclose"], rorder, n)
rcodes = jnp.where(rpos < cfg.N, codes[jnp.clip(rpos, 0, cfg.N - 1)], 0)
cor = FJ._correlate(cfg, eng.W, rcodes, mlen, eng.integral)
lags, lvals = FJ._top_lags(cfg, cor)
lag_ok = (lvals > FJ.NEG / 2) & (mlen[:, :, None] >= 2) & state["active"][0][:, None, None]
ws = FJ._window_scan(cfg, dp, eng.W, rcodes, rpos, mlen, lags, lag_ok)
delta, cplx, has, p0, q0, a, b2 = FJ._candidate_delta(
    cfg, dp, codes, n, keys, pt, loops, rorder, rpos, mlen, ws, lags)

print("rorder[k]:", np.asarray(rorder[k]))
print("mlen[k]:", np.asarray(mlen[k]))
for r in range(cfg.R):
    ml = int(mlen[k, r])
    if ml == 0:
        continue
    rp = np.asarray(rpos[k, r][:ml])
    print(f"region r={r} label={int(rorder[k,r])} len={ml} pos[{rp[0]}..{rp[-1]}]")
    # all accepted candidates
    for mm in range(cfg.M):
        if not bool(lag_ok[k, r, mm]):
            continue
        run = int(ws["max_nb"][k, r, mm])
        if run <= 0:
            continue
        d = int(delta[k, r, mm])
        cx = bool(cplx[k, r, mm])
        if d < 0 or cx:
            i_s = int(ws["max_i"][k, r, mm])
            j_s = int(ws["max_j"][k, r, mm])
            gi = rp[i_s] if i_s < ml else -1
            gj = rp[j_s] if j_s < ml else -1
            print(f"  m={mm} lag={int(lags[k,r,mm])} run={run} "
                  f"local=({i_s},{j_s}) glob=({gi},{gj}) delta={d} cplx={cx}")

# ---- component probe for lane (k, r=0, m=61): the -834 vs -833 stem
from rafft_tpu.energy.eval_jax import _hairpin as J_hairpin, _int_loop as J_int_loop
kk, rr, mm = k, 0, 61
print("\ncomponent probe lane", (kk, rr, mm))
print("best_sE =", int(ws["best_sE"][kk, rr, mm]), "(expect -1090)")
print("run/max_i/max_j:", int(ws["max_nb"][kk, rr, mm]),
      int(ws["max_i"][kk, rr, mm]), int(ws["max_j"][kk, rr, mm]))
hpj = J_hairpin(dp, codes, n, jnp.int32(22), jnp.int32(70), *keys)
print("J hairpin(22,70) =", int(hpj), "(expect 768)")
ilj = J_int_loop(dp, codes, n, jnp.int32(17), jnp.int32(76), jnp.int32(18), jnp.int32(74))
print("J int_loop =", int(ilj), "(expect 240)")
print("loop_e[k][17] =", int(loops["loop_e"][kk][17]), "(expect 751)")
print("delta =", int(delta[kk, rr, mm]), "(expect -833)")

FJ.DEBUG_CAPTURE = {}
delta2, *_ = FJ._candidate_delta(
    cfg, dp, codes, n, keys, pt, loops, rorder, rpos, mlen, ws, lags)
D = FJ.DEBUG_CAPTURE
for name in ("innerE", "dL", "cin", "hpE", "bL", "bLn", "sw", "il_new",
             "eL", "a", "b2", "p0", "q0", "ngaps", "lo_sw", "hi_sw"):
    print(name, "=", int(D[name][kk, rr, mm]))
