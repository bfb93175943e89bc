"""Attribute every energy-diverged best-energy row engine-by-engine.

VERDICT r4 item 4.  For each corpus row whose best-energy prediction
diverges in ENERGY from the reference's frozen artifact
(fft_100n_50ms_best_nrj_scores.csv), this tool:

  1. evaluates OUR integer Turner oracle on the REFERENCE's structure —
     if that reproduces the reference's printed energy, the energy table
     is exonerated for the row (divergence is search-path, not model);
  2. re-folds the sequence fresh on the sequential CPU parity engine
     (scipy-convolve correlation, reference tie order) and classes the
     row:
       cpu=ref    CPU refold reproduces the reference row -> our
                  committed row was a batched-engine (f32 FFT tie /
                  budget-fallback) artifact, closable on our side;
       cpu=ours   CPU refold reproduces our committed row  -> fresh
                  deterministic runs agree with us, the frozen artifact
                  reflects historical noise (ViennaRNA build / authors'
                  run), not closable mechanically;
       3-way      all three differ -> correlation tie-ordering cascade.

Writes benchmarks/artifacts/divergence_attribution.md (+ jsonl detail)
with a per-class histogram.  Matches the reference selection
(score_best.py:88-96: lowest-energy saved structure).

Usage: python tools/attribute_divergence.py [--ours CSV] [--limit N]
"""
import argparse
import csv
import json
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/benchmark_results/fft_100n_50ms_best_nrj_scores.csv"
OURS = "benchmarks/artifacts/fft_100n_50ms_best_nrj_scores.csv"
OUT_MD = "benchmarks/artifacts/divergence_attribution.md"
OUT_JL = "benchmarks/artifacts/divergence_attribution.jsonl"


def _refold(task):
    name, seq = task
    from rafft_tpu.engine.fold_cpu import fold
    t0 = time.time()
    structs = fold(seq, nb_mode=100, max_stack=50, max_branch=1000)
    best = structs[0]
    return name, best.str_struct, round(float(best.energy), 1), \
        round(time.time() - t0, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ours", default=OURS)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--workers", type=int, default=max(1, mp.cpu_count()))
    args = ap.parse_args()

    from rafft_tpu.energy.eval_np import eval_structure_int

    ref = {}
    with open(REF) as fh:
        for r in csv.DictReader(fh):
            ref[(r["seq"], r["name"])] = (r["struct"],
                                          round(float(r["nrj"]), 1))
    ours = {}
    with open(args.ours) as fh:
        for r in csv.DictReader(fh):
            ours[(r["seq"], r["name"])] = (r["struct"],
                                           round(float(r["nrj"]), 1))

    diverged = []
    for key, (rdb, re_) in ref.items():
        if key in ours and abs(ours[key][1] - re_) > 0.05:
            diverged.append(key)
    diverged.sort(key=lambda k: len(k[0]))
    if args.limit:
        diverged = diverged[: args.limit]
    print(f"{len(diverged)} energy-diverged rows", flush=True)

    # resume from partial jsonl
    done = {}
    if os.path.exists(OUT_JL):
        with open(OUT_JL) as fh:
            for line in fh:
                row = json.loads(line)
                done[(row["seq"], row["name"])] = row

    todo = [k for k in diverged if k not in done]
    # stage 1: oracle on the reference's structure (cheap, all rows)
    oracle = {}
    for seq, name in diverged:
        rdb, re_ = ref[(seq, name)]
        e = eval_structure_int(seq, rdb) / 100.0
        oracle[(seq, name)] = round(e, 1)

    # stage 2: CPU refolds (expensive) — forkserver pool, resumable
    ctx = mp.get_context("forkserver")
    with ctx.Pool(args.workers) as pool, open(OUT_JL, "a") as out:
        tasks = [(name, seq) for seq, name in todo]
        name2seq = {name: seq for seq, name in todo}
        for name, db, e, secs in pool.imap_unordered(_refold, tasks):
            seq = name2seq[name]
            row = dict(seq=seq, name=name, cpu_struct=db, cpu_nrj=e,
                       secs=secs)
            done[(seq, name)] = row
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(f"  [{len(done)}/{len(diverged)}] {name} ({len(seq)} nt) "
                  f"{secs}s", flush=True)

    # classify
    classes = {"cpu=ref": [], "cpu=ours": [], "3-way": []}
    table_err = []
    for seq, name in diverged:
        rdb, re_ = ref[(seq, name)]
        odb, oe = ours[(seq, name)]
        c = done[(seq, name)]
        cdb, ce = c["cpu_struct"], c["cpu_nrj"]
        if abs(oracle[(seq, name)] - re_) > 0.05:
            table_err.append(name)
        if abs(ce - re_) <= 0.05 and cdb == rdb:
            cls = "cpu=ref"
        elif abs(ce - oe) <= 0.05 and cdb == odb:
            cls = "cpu=ours"
        elif abs(ce - re_) <= 0.05:
            cls = "cpu=ref"      # same energy, tie-variant structure
        elif abs(ce - oe) <= 0.05:
            cls = "cpu=ours"
        else:
            cls = "3-way"
        classes[cls].append((name, len(seq), oe, re_, ce))

    n = len(diverged)
    with open(OUT_MD, "w") as fh:
        fh.write("# Energy-diverged best-energy rows: engine-by-engine "
                 "attribution\n\n")
        fh.write(f"Generated by tools/attribute_divergence.py over the "
                 f"{n} rows of `fft_100n_50ms_best_nrj_scores.csv` whose "
                 "best energies diverge from the frozen reference "
                 "artifact (parity_report.md).\n\n")
        fh.write("## Energy-table exoneration\n\n")
        fh.write(f"Our integer Turner oracle evaluated on the REFERENCE's "
                 f"structure reproduces the reference's printed energy on "
                 f"**{n - len(table_err)}/{n}** rows")
        if table_err:
            fh.write(f"; exceptions: {', '.join(table_err)}.\n\n")
        else:
            fh.write(" — zero energy-model errors on the divergence "
                     "surface; every divergence is search-path.\n\n")
        fh.write("## Fresh CPU-parity refold classes\n\n")
        fh.write("| class | rows | meaning |\n|---|---|---|\n")
        fh.write(f"| cpu=ref | {len(classes['cpu=ref'])} | our committed "
                 "row was a batched-engine artifact (f32 FFT tie order or "
                 "budget fallback); fresh CPU refold matches the "
                 "reference |\n")
        fh.write(f"| cpu=ours | {len(classes['cpu=ours'])} | fresh "
                 "deterministic refold agrees with our row; the frozen "
                 "artifact is historical (authors' ViennaRNA build / run) "
                 "|\n")
        fh.write(f"| 3-way | {len(classes['3-way'])} | correlation "
                 "tie-ordering cascade: ours, the reference's and a fresh "
                 "CPU refold all differ |\n\n")
        for cls, rows in classes.items():
            if not rows:
                continue
            fh.write(f"### {cls} ({len(rows)})\n\n")
            fh.write("| name | len | ours | ref | cpu-refold |\n"
                     "|---|---|---|---|---|\n")
            for name, ln, oe, re_, ce in sorted(rows, key=lambda r: r[1]):
                fh.write(f"| {name} | {ln} | {oe} | {re_} | {ce} |\n")
            fh.write("\n")
    print(f"wrote {OUT_MD}: cpu=ref {len(classes['cpu=ref'])}, "
          f"cpu=ours {len(classes['cpu=ours'])}, "
          f"3-way {len(classes['3-way'])}, table_err {len(table_err)}")


if __name__ == "__main__":
    main()
