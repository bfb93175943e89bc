"""Find the first step where the batched engine diverges from the CPU engine."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import csv
import numpy as np

from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig
from rafft_tpu.engine.fold_cpu import fold as cpu_fold

CORPUS = "/root/reference/benchmark_results/benchmark_cleaned_all_length.csv"
seqs = []
with open(CORPUS) as fh:
    for row in csv.reader(fh):
        if len(row) >= 3 and len(row[0]) <= 120:
            seqs.append(row[0])

IDX = int(sys.argv[1]) if len(sys.argv) > 1 else 7
seq = seqs[IDX]
print("len", len(seq))

res, traj = cpu_fold(seq, nb_mode=100, max_stack=50, max_branch=1000,
                     traj=True)
cpu_steps = [[(s.str_struct, s.energy) for s in step] for step in traj]
cpu_steps.append([(s.str_struct, s.energy) for s in res])

cfg = EngineConfig(N=128, K=50, R=16, M=100, V=4096, S=16384, max_branch=1000)
eng = FoldEngine(cfg, B=1)
state = eng.init_state([seq])
for step in range(cfg.max_steps):
    if bool(np.asarray(state["done"]).all()):
        break
    beams = eng._beams(state, 1)[0]
    want = cpu_steps[step] if step < len(cpu_steps) else cpu_steps[-1]
    if beams != want:
        print(f"DIVERGED at step {step}: jax {len(beams)} cpu {len(want)}")
        sw = set(want)
        sg = set(beams)
        for i, (g, w) in enumerate(zip(beams, want)):
            if g != w:
                print(f"  k={i}")
                print(f"   got  {g}")
                print(f"   want {w}")
                if i > 6:
                    break
        print("  missing from jax:", [x for x in want if x not in sg][:4])
        print("  extra in jax    :", [x for x in beams if x not in sw][:4])
        break
    state = eng._step(state)
else:
    print("no divergence in stepped beams")
print("suspect:", np.asarray(state["enum_suspect"]),
      "cplx_dropped:", np.asarray(state["cplx_dropped"]))
