"""Assemble the full-corpus result CSVs from sweep + long-tail runs.

Reads the device sweep checkpoint journal (<=1024-nt buckets,
rafft_tpu/parallel/sweep.py) and the long-tail journal
(tools/fold_longtail.py, the two >1024-nt 23S rRNAs) and writes the two
reference-schema result CSVs in corpus order:

  fft_100n_50ms_best_nrj_scores.csv  — lowest-energy structure
                                       (ref benchmark_results/score_best.py)
  fft_100n_50ms_scores.csv           — best-of-k over the saved beam
                                       (ref benchmark_results/get_best_score.py)

Rows are keyed by (seq, name); the tool errors on any corpus row with no
result (the deliverable is 2,296/2,296 coverage, not a silent subset).

Usage:
  python tools/merge_corpus.py --ckpt sweep.ckpt.jsonl longtail.ckpt.jsonl \
      --out-best-nrj A.csv --out-best-of-k B.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CORPUS = ("/root/reference/benchmark_results/"
          "benchmark_cleaned_all_length.csv")
HEADER = "seq,len_seq,struct,nrj,nbp,pvv,sens,name\n"


def load_journals(paths):
    rows = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                r = json.loads(line)
                rows[(r["seq"], r["name"])] = r
    return rows


def write_csv(path, corpus, rows, selection):
    with open(path, "w") as fh:
        fh.write(HEADER)
        for seq, _true, name in corpus:
            r = rows[(seq, name)]
            if selection == "best_of_k" and "struct_bk" in r:
                db, e = r["struct_bk"], r["nrj_bk"]
                ppv, sens = r["pvv_bk"], r["sens_bk"]
            else:
                db, e = r["struct"], r["nrj"]
                ppv, sens = r["pvv"], r["sens"]
            fh.write(f"{seq},{len(seq)},{db},{e},{db.count('(')},"
                     f"{ppv},{sens},{name}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", nargs="+", required=True,
                    help="journal jsonl files (sweep checkpoint + longtail)")
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--out-best-nrj", required=True)
    ap.add_argument("--out-best-of-k", required=True)
    ap.add_argument("--allow-missing", type=int, default=0, metavar="N",
                    help="tolerate up to N corpus rows without results "
                         "(each is named on stderr; the CSVs then hold "
                         "fewer rows — an explicit, logged exception to "
                         "the 2,296-row completeness guard)")
    args = ap.parse_args(argv)

    corpus = [(r[0], r[1], r[2]) for r in csv.reader(open(args.corpus))
              if len(r) >= 3]
    rows = load_journals(args.ckpt)
    missing = [(name, len(seq)) for seq, _t, name in corpus
               if (seq, name) not in rows]
    if missing:
        for name, ln in missing[:20]:
            print(f"MISSING {name} ({ln} nt)", file=sys.stderr)
        if len(missing) > args.allow_missing:
            sys.exit(f"{len(missing)} corpus rows have no result — "
                     f"refusing to write a partial artifact")
        corpus = [r for r in corpus if (r[0], r[2]) in rows]
    write_csv(args.out_best_nrj, corpus, rows, "best_nrj")
    write_csv(args.out_best_of_k, corpus, rows, "best_of_k")
    print(f"{len(corpus)} rows -> {args.out_best_nrj}, "
          f"{args.out_best_of_k}")


if __name__ == "__main__":
    main()
