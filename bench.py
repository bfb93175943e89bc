"""Benchmark entry point — runs on the GPU and fails without one.

Measures the batched fold engine's throughput on the reference benchmark
corpus at the reference's headline configuration (-n 100 -ms 50,
/root/reference/benchmark_results/bench_fft.py:8) and prints ONE JSON
line naming the device it ran on.

The headline metric stays the <=120-nt slice (round-to-round
continuity); the JSON additionally carries `per_bucket` sampled rates
for every length bucket the batched engine serves (128..1024) and
`corpus_seqs_per_s`, the whole-corpus rate implied by those rates and
the corpus's true bucket populations.  The 10 sequences over 1024 nt (0.4%
of the corpus) run on the sequential CPU longtail path
(tools/fold_longtail.py) and are excluded from the measured aggregate —
their bucket entries say so rather than pretending coverage.

Baseline: the reference publishes no runtime numbers (BASELINE.md).
tools/measure_baseline.py times the sequential CPU parity engine (the
same beam loop as the reference with an equally-priced table oracle in
place of in-process ViennaRNA) over a corpus sample and freezes the
result in benchmarks/baseline_cpu.json; that measured number is the
1-core baseline here (fallback 1.0 seq/s if the artifact is missing).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CORPUS = "/root/reference/benchmark_results/benchmark_cleaned_all_length.csv"
BASELINE_ART = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks", "baseline_cpu.json")

# (bucket N, sample size) — samples sized to keep bench wall-time sane;
# per-bucket rates are steady-state (compile + warmup excluded).  No 64
# bucket: <=64-nt sequences fold at N=128 (sweep.DEFAULT_BUCKETS note)
BUCKET_SAMPLES = ((128, 256), (256, 16), (512, 8), (1024, 4))


def bucket_rate(N, sample, seqs_by_bucket):
    """Steady-state seq/s for one bucket at the sweep's config."""
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig
    from rafft_tpu.parallel.sweep import bucket_batch

    seqs = seqs_by_bucket.get(N, [])
    if not seqs:
        return None, 0
    take = seqs[:sample]
    B = bucket_batch(16, N)
    cfg = EngineConfig(N=N, K=50, M=min(100, 2 * N - 1),
                       R=16 if N <= 512 else 32, max_branch=1000,
                       V=4096, W=8 if N <= 128 else 24, S=16384)
    eng = FoldEngine(cfg, B=B)
    warm = take[:B]
    for _ in eng.run_stream(warm):
        pass
    t0 = time.time()
    n = sum(1 for _ in eng.run_stream(take))
    return n / (time.time() - t0), n


def device_info():
    """The device the numbers come from; exits when it is not a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's default device "
                         f"is {devs[0].platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    name, _, limit = smi.stdout.strip().splitlines()[0].partition(", ")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": name, "power_limit": limit}


def main():
    import csv

    device = device_info()
    base = 1.0
    if os.path.exists(BASELINE_ART):
        with open(BASELINE_ART) as fh:
            base = float(json.load(fh)["seqs_per_s"])

    buckets = [b for b, _ in BUCKET_SAMPLES]
    seqs_by_bucket = {}
    counts = {}
    n_longtail = 0
    if os.path.exists(CORPUS):
        with open(CORPUS) as fh:
            for row in csv.reader(fh):
                if len(row) < 3:
                    continue
                L = len(row[0])
                for b in buckets:
                    if L <= b:
                        seqs_by_bucket.setdefault(b, []).append(row[0])
                        counts[b] = counts.get(b, 0) + 1
                        break
                else:
                    n_longtail += 1
    if not seqs_by_bucket:  # fallback corpus
        import numpy as np
        rng = np.random.default_rng(0)
        seqs_by_bucket = {128: ["".join(rng.choice(list("ACGU"), 100))
                                for _ in range(64)]}
        counts = {128: 64}

    per_bucket = {}
    agg_time = 0.0
    agg_n = 0
    for N, sample in BUCKET_SAMPLES:
        rate, n = bucket_rate(N, sample, seqs_by_bucket)
        if rate is None:
            continue
        per_bucket[str(N)] = dict(seqs_per_s=round(rate, 3),
                                  sampled=n, corpus_n=counts.get(N, 0))
        agg_time += counts.get(N, 0) / rate
        agg_n += counts.get(N, 0)
    corpus_rate = agg_n / agg_time if agg_time else 0.0

    # headline: the round-1..4 metric unchanged for continuity —
    # every corpus sequence <= 120 nt, N=128/K=50/B=16, first 256
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig
    head_seqs = []
    if os.path.exists(CORPUS):
        with open(CORPUS) as fh:
            for row in csv.reader(fh):
                if len(row) >= 3 and len(row[0]) <= 120:
                    head_seqs.append(row[0])
    head_seqs = head_seqs[:256] or seqs_by_bucket.get(128, [])[:64]
    eng = FoldEngine(EngineConfig(N=128, K=50, R=16, M=100, V=4096,
                                  S=16384, max_branch=1000), B=16)
    for _ in eng.run_stream(head_seqs[:16]):
        pass
    t0 = time.time()
    folded = sum(1 for _ in eng.run_stream(head_seqs))
    t_head = time.time() - t0
    head = folded / t_head
    cells = sum(len(s) ** 2 for s in head_seqs)
    t_equiv = t_head

    print(json.dumps({
        "metric": "fold_throughput_n100_ms50_le120nt",
        "value": round(head, 3),
        "unit": "seq/s",
        "vs_baseline": round(head / base, 2),
        "n_seqs": folded,
        "gcups": round(cells / t_equiv / 1e9, 4),
        "per_bucket": per_bucket,
        "corpus_seqs_per_s": round(corpus_rate, 3),
        "corpus_covered": agg_n,
        "corpus_excluded_gt1024nt": n_longtail,
        "baseline_seqs_per_s": base,
        "device": device,
    }))


if __name__ == "__main__":
    main()
