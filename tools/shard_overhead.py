"""Bound the per-device overhead of the sharded fold program.

On the GPU: run the same run_stream workload (a) unsharded and
(b) sharded over a 1-device mesh (shard_map-compatible NamedSharding
placement, the exact code path the multi-chip sweep uses).  The delta
bounds the sharding machinery's per-device cost.  chip_smoke.py --four
checks the 4-card sweep against one card.

Usage: python tools/shard_overhead.py [n_seqs]
"""
import csv
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CORPUS = "/root/reference/benchmark_results/benchmark_cleaned_all_length.csv"


def main():
    n_seqs = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig
    from rafft_tpu.parallel.mesh import data_mesh, shard_state

    seqs = []
    with open(CORPUS) as fh:
        for row in csv.reader(fh):
            if len(row) >= 3 and len(row[0]) <= 120:
                seqs.append(row[0])
    seqs = seqs[:n_seqs]

    cfg = EngineConfig(N=128, K=50, R=16, M=100, V=4096, S=16384,
                       max_branch=1000)
    eng = FoldEngine(cfg, B=16)
    mesh = data_mesh(1)
    shard = lambda st: shard_state(st, mesh)

    rates = {}
    for label, sh in (("unsharded", None), ("sharded_1dev", shard)):
        for _ in eng.run_stream(seqs[:32], shard=sh):   # warm
            pass
        t0 = time.time()
        n = sum(1 for _ in eng.run_stream(seqs, shard=sh))
        rates[label] = n / (time.time() - t0)
        print(f"{label:>14}: {rates[label]:6.2f} seq/s", flush=True)

    ovh = 100.0 * (1.0 - rates["sharded_1dev"] / rates["unsharded"])
    print(f"sharding overhead on one real chip: {ovh:+.1f}%")


if __name__ == "__main__":
    main()
