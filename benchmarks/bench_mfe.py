"""MFE baseline sweep — native replacement for the reference's
benchmark_results/{bench_mfe.py,src/vrna_mfe.py} (ViennaRNA `RNA.fold`
fan-out).  Folds every corpus sequence to its MFE structure with the
framework's own Zuker engine and writes the reference's result-CSV
schema `seq,len_seq,struct,nrj,nbp,pvv,sens,name` (scored with the
built-in slip-rule scorer).

  python benchmarks/bench_mfe.py [--csv PATH] [--out mfe_rafft_tpu.csv]
      [--limit N] [--max_len N] [--jax] [--batch 16]
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_CSV = "/root/reference/benchmark_results/benchmark_cleaned_all_length.csv"


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default=DEFAULT_CSV)
    ap.add_argument("--out", default="mfe_rafft_tpu.csv")
    ap.add_argument("--limit", type=int)
    ap.add_argument("--max_len", type=int)
    ap.add_argument("--jax", action="store_true",
                    help="use the batched JAX DP instead of native C++")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()

    from rafft_tpu.scoring import score_structures

    records = []
    with open(args.csv) as fh:
        for row in csv.reader(fh):
            if len(row) >= 3:
                records.append((row[0], row[1], row[2]))
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.limit:
        records = records[: args.limit]

    t0 = time.time()
    results = []
    if args.jax:
        from rafft_tpu.mfe.mfe_jax import MfeEngine

        byN = {}
        for idx, (seq, _t, _n) in enumerate(records):
            N = 1 << max(5, (len(seq) - 1).bit_length())
            byN.setdefault(N, []).append(idx)
        results = [None] * len(records)
        for N, idxs in sorted(byN.items()):
            eng = MfeEngine(N, B=args.batch)
            for off in range(0, len(idxs), args.batch):
                chunk = idxs[off: off + args.batch]
                out = eng.fold([records[i][0] for i in chunk])
                for i, (db, e) in zip(chunk, out):
                    results[i] = (db, e)
    else:
        from rafft_tpu.mfe import mfe_fold

        for seq, _t, _n in records:
            results.append(mfe_fold(seq))
    dt = time.time() - t0

    with open(args.out, "w") as out:
        w = csv.writer(out)
        w.writerow(["seq", "len_seq", "struct", "nrj", "nbp", "pvv", "sens",
                    "name"])
        for (seq, true_st, name), (db, e) in zip(records, results):
            ppv, sens = score_structures(db, true_st)
            w.writerow([seq, len(seq), db, e, db.count("("),
                        f"{ppv:.2f}", f"{sens:.2f}", name])
    print(f"{len(records)} seqs in {dt:.1f}s "
          f"({len(records) / max(dt, 1e-9):.1f} seq/s) -> {args.out}")


if __name__ == "__main__":
    main()
