"""Fold the >1024-nt corpus tail on the CPU parity engine.

The two 23S rRNAs (2,915 / 2,968 nt) exceed the batched engine's R=32
region budget, so they would be flagged to the CPU fallback inside the
sweep anyway (rafft_tpu/parallel/sweep.py finish()); folding them here,
concurrently with the device sweep, keeps the chip busy on the bucketed
corpus.  Emits rows in the sweep checkpoint-journal schema so
tools/merge_corpus.py can assemble the full 2,296-row result CSVs.

Reference workload: benchmark_results/bench_fft.py:17-21 folds the whole
benchmark_cleaned_all_length.csv including these sequences.

Usage:
  python tools/fold_longtail.py --csv <benchmark.csv> \
      --out benchmarks/artifacts/longtail.ckpt.jsonl [--min_len 1025]
"""

from __future__ import annotations

import argparse
import csv
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fold_one(task):
    idx, seq, true_db, name, nb_mode, max_stack, max_branch = task
    from rafft_tpu.engine.fold_cpu import fold
    from rafft_tpu.scoring import score_structures, best_of

    t0 = time.time()
    structs = fold(seq, nb_mode=nb_mode, max_stack=max_stack,
                   max_branch=max_branch)
    rows = [(s.str_struct, s.energy) for s in structs]
    beam = [[d, float(np.float32(ee))] for d, ee in rows]
    db, e = rows[0]
    ppv, sens = score_structures(db, true_db)
    ppv_bk, sens_bk, db_bk = best_of([d for d, _ in rows], true_db)
    emap = dict(rows)
    e_bk = emap.get(db_bk, e)
    return dict(seq=seq, len_seq=len(seq), struct=db,
                nrj=float(np.float32(e)), nbp=db.count("("),
                pvv=ppv, sens=sens, struct_bk=db_bk,
                nrj_bk=float(np.float32(e_bk)), pvv_bk=ppv_bk,
                sens_bk=sens_bk, name=name, _idx=idx, _bucket=4096,
                _secs=round(time.time() - t0, 1), _engine="cpu",
                _beam=beam)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--min_len", type=int, default=1025)
    ap.add_argument("-n", "--nb_mode", type=int, default=100)
    ap.add_argument("-ms", "--max_stack", type=int, default=50)
    ap.add_argument("--max_branch", type=int, default=1000)
    ap.add_argument("--save-beams", dest="save_beams",
                    help="jsonl path: full saved beam per sequence "
                         "(sweep --save-beams schema)")
    args = ap.parse_args(argv)

    recs = []
    with open(args.csv) as fh:
        for i, row in enumerate(csv.reader(fh)):
            if len(row) >= 3 and len(row[0]) >= args.min_len:
                recs.append((i, row[0], row[1], row[2], args.nb_mode,
                             args.max_stack, args.max_branch))
    print(f"[longtail] {len(recs)} sequences >= {args.min_len} nt",
          flush=True)
    beam_fh = open(args.save_beams, "w") if args.save_beams else None
    with mp.Pool(min(len(recs), mp.cpu_count())) as pool, \
            open(args.out, "w") as out:
        for res in pool.imap_unordered(_fold_one, recs):
            secs = res.pop("_secs")
            res.pop("_engine")
            beam = res.pop("_beam")
            if beam_fh is not None:
                beam_fh.write(json.dumps(dict(
                    name=res["name"], seq=res["seq"], flagged=False,
                    beam=beam)) + "\n")
                beam_fh.flush()
            out.write(json.dumps(res) + "\n")
            out.flush()
            print(f"[longtail] {res['name']} ({res['len_seq']} nt) in "
                  f"{secs}s: nrj {res['nrj']:.1f} ppv {res['pvv']} "
                  f"sens {res['sens']}", flush=True)
    if beam_fh is not None:
        beam_fh.close()


if __name__ == "__main__":
    main()
