"""Length-bucketed, data-parallel benchmark sweep.

Device replacement for the reference's per-sequence subprocess fan-out
(/root/reference/benchmark_results/bench_fft.py): sequences are bucketed
by padded length, folded in device-resident batches on a ('data',) mesh,
scored with the built-in slip-rule scorer, and written as the reference's
result-CSV schema `seq,len_seq,struct,nrj,nbp,pvv,sens,name`
(scoring.py:119-127).

Per-bucket checkpointing: each finished bucket's rows are flushed to
<out>.part.<N>; a restart skips completed buckets (the failure-recovery
capability the reference lacks, SURVEY.md section 5).

CLI:
  python -m rafft_tpu.parallel.sweep --csv <benchmark.csv> --out results.csv \
      -n 100 -ms 50 [--limit 200] [--buckets 64,128,256] [--batch 16]
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

# no 64 bucket: N=64 is below the wavefront's shape limits
# (engine/wavefront.supported), so it would take the Hankel-stack window
# scan, whose memory grows as K*R*N^2
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)

# engine exactness-flag bits -> cause names (fold_jax.FLAG_*)
FLAG_NAMES = {1: "v_window", 2: "r_slots", 4: "seen_set", 8: "hash_check",
              16: "cplx_budget", 32: "step_limit"}


def _cpu_refold(task):
    """Pool worker: re-fold one flagged sequence on the sequential
    CPU-parity engine (bit-exact reference semantics)."""
    i, seq, nb_mode, max_stack, max_branch = task
    from rafft_tpu.engine.fold_cpu import fold as cpu_fold
    structs = cpu_fold(seq, nb_mode=nb_mode, max_stack=max_stack,
                       max_branch=max_branch)
    return i, [(s.str_struct, s.energy) for s in structs]


def _cpu_only():
    """Pool initializer: keep the worker off the accelerator."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")


def refold_pool(workers):
    """Process pool for CPU-parity refolds.

    forkserver: the parent holds a live accelerator client by now, and
    forking such a process can wedge the children.  The fork server and
    its workers start with JAX_PLATFORMS=cpu, so none of them opens the
    card even though the server preloads __main__."""
    ctx = mp.get_context("forkserver")
    prev = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        return ctx.Pool(workers, initializer=_cpu_only)
    finally:
        if prev is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = prev


def load_benchmark_csv(path):
    """Rows of (seq, true_struct, name)."""
    out = []
    with open(path) as fh:
        for row in csv.reader(fh):
            if len(row) >= 3:
                out.append((row[0], row[1], row[2]))
    return out


def bucket_of(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return None


def bucket_batch(batch, N):
    """Per-bucket batch size: the engine's working set grows about
    linearly in N, so long buckets shrink the batch.  The halving per
    doubling above N=256 was fitted to the first backend's device
    memory; it has not been re-tuned for the H100's."""
    return max(1, batch * 256 // max(N, 256))


def bucket_config(N, nb_mode=100, max_stack=50, max_branch=1000):
    """The engine configuration of one length bucket.

    A region of padded length N has at most 2N-1 correlation lags, so
    top-M lag selection saturates there (the reference just takes every
    lag when nb_mode exceeds them).

    Combination windows: long sequences carry more regions and more
    accepted candidates per region, so their per-step combination
    products are duplicate-heavy and overflow any single window long
    before the reference's max_branch new-structure cap.  The engine
    walks the combination space in V-slabs (fold_jax windowed
    enumeration); long buckets get a deeper window budget."""
    from rafft_tpu.engine.fold_jax import EngineConfig
    return EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                        R=16 if N <= 512 else 32, max_branch=max_branch,
                        V=4096, W=8 if N <= 128 else 24,
                        CPLX=512 if N <= 128 else 1024,
                        S=max(16384, 32 * max_stack))


def device_peak_bytes():
    """Peak bytes in use on the first device so far, or None where the
    backend keeps no such count."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def sweep(records, nb_mode=100, max_stack=50, max_branch=1000,
          buckets=DEFAULT_BUCKETS, batch=16, mesh=None, best_of_k=False,
          progress=None, checkpoint=None, save_beams=None, stats=None,
          workers=None, engine="jax"):
    """Fold every record; returns list of result dicts in input order.

    save_beams: optional jsonl path; every folded sequence appends
    {name, seq, flagged, beam: [[db, nrj], ...]} so any best-of-k
    selection rule can be re-scored offline without re-folding
    (sequences restored from a checkpoint are not re-appended).
    stats: optional dict populated with run counters (n_fallback,
    per-bucket timings) for the run manifest.

    Each result carries BOTH selections the reference publishes: the
    best-energy structure (struct/nrj/pvv/sens, score_best.py) and the
    best-PPV structure among the max_stack saved ones
    (struct_bk/nrj_bk/pvv_bk/sens_bk, get_best_score.py).  best_of_k
    selects which pair fills the primary columns."""
    from rafft_tpu.scoring import score_structures, best_of
    if engine == "jax":
        from rafft_tpu.engine.fold_jax import FoldEngine
        from rafft_tpu.parallel.mesh import shard_state

    # the parent only dispatches while the pool folds, so use every core
    workers = workers or max(1, mp.cpu_count())

    by_bucket: dict[int, list[int]] = {}
    for i, (seq, _t, _n) in enumerate(records):
        b = bucket_of(len(seq), buckets)
        if b is not None:
            by_bucket.setdefault(b, []).append(i)

    results = [None] * len(records)
    n_fallback = 0
    flag_hist: dict[str, int] = {}
    done_buckets = set()
    if checkpoint and os.path.exists(checkpoint):
        with open(checkpoint) as fh:
            for line in fh:
                row = json.loads(line)
                results[row.pop("_idx")] = row
                done_buckets.add(row.pop("_bucket"))

    for N, idxs in sorted(by_bucket.items()):
        if N in done_buckets:
            continue
        t_bucket = time.time()
        beam_fh = open(save_beams, "a") if save_beams else None

        def finish(i, rows, flagged):
            seq, true_db, name = records[i]
            if not rows:
                rows = [("." * len(seq), 0.0)]
            if beam_fh is not None:
                beam_fh.write(json.dumps(dict(
                    name=name, seq=seq, flagged=int(flagged),
                    beam=[[d, float(np.float32(ee))] for d, ee in rows]))
                    + "\n")
            db, e = rows[0]
            ppv, sens = score_structures(db, true_db)
            ppv_bk, sens_bk, db_bk = best_of([d for d, _ in rows], true_db)
            emap = dict(rows)
            e_bk = emap.get(db_bk, 0.0)
            if db_bk not in emap:        # best_of's all-dots default is
                db_bk, ppv_bk, sens_bk = db, ppv, sens
                e_bk = e
            results[i] = dict(seq=seq, len_seq=len(seq),
                              struct=db, nrj=float(np.float32(e)),
                              nbp=db.count("("), pvv=ppv, sens=sens,
                              struct_bk=db_bk, nrj_bk=float(np.float32(e_bk)),
                              pvv_bk=ppv_bk, sens_bk=sens_bk,
                              name=name)
            if best_of_k:
                results[i].update(struct=db_bk,
                                  nrj=float(np.float32(e_bk)),
                                  nbp=db_bk.count("("),
                                  pvv=ppv_bk, sens=sens_bk)

        n_done = 0
        flag_of: dict[int, int] = {}   # original flag bits per refold row
        pending = []   # flagged sequences: exactness escape hatch — the
        # engine flags folds whose combination-enumeration window /
        # complex-candidate budget / seen-set capacity could not
        # guarantee bit-exact reference semantics; those re-fold on the
        # sequential CPU-parity engine, in parallel after the stream
        if engine == "cpu":
            # device-less mode: the whole bucket runs on the sequential
            # parity engine, fanned out over a process pool (the
            # reference's Pool model, bench_fft.py:17-21, minus the
            # per-sequence interpreter respawn)
            pending = [(i, records[i][0], nb_mode, max_stack, max_branch)
                       for i in idxs]
        else:
            cfg = bucket_config(N, nb_mode, max_stack, max_branch)
            eng = FoldEngine(cfg, B=bucket_batch(batch, N))
            # device-side continuous batching: the chip swaps finished
            # lanes onto preloaded shadow sequences inside one device
            # program; the host drains banked results every few steps
            shard = (lambda st: shard_state(st, mesh)) \
                if mesh is not None else None
            bucket_seqs = [records[i][0] for i in idxs]
            for local_i, rows, flagged in eng.run_stream(bucket_seqs,
                                                         shard=shard):
                n_fallback += int(bool(flagged))
                if flagged:
                    # flagged is a FLAG_* cause bitmask — histogram the
                    # causes so the binding budget can be engineered down
                    for bit, cause in FLAG_NAMES.items():
                        if int(flagged) & bit:
                            flag_hist[cause] = flag_hist.get(cause, 0) + 1
                    i = idxs[local_i]
                    flag_of[i] = int(flagged)
                    pending.append((i, records[i][0], nb_mode, max_stack,
                                    max_branch))
                else:
                    finish(idxs[local_i], rows, False)
                n_done += 1
                if progress:
                    progress(N, n_done, len(idxs))
        if pending:
            with refold_pool(min(len(pending), workers)) as pool:
                for i, rows in pool.imap_unordered(_cpu_refold, pending):
                    finish(i, rows, flag_of.get(i, 0)
                           if engine != "cpu" else 0)
                    n_done += 1
                    if progress and engine == "cpu":
                        progress(N, n_done, len(idxs))
        if beam_fh is not None:
            beam_fh.close()
        if checkpoint:
            with open(checkpoint, "a") as fh:
                for i in idxs:
                    if results[i] is not None:
                        row = dict(results[i])
                        row["_idx"] = i
                        row["_bucket"] = N
                        fh.write(json.dumps(row) + "\n")
        if stats is not None:
            stats.setdefault("buckets", {})[str(N)] = dict(
                n=len(idxs), secs=round(time.time() - t_bucket, 1),
                batch=bucket_batch(batch, N),
                peak_bytes_in_use=(device_peak_bytes()
                                   if engine == "jax" else None))
        if progress:
            progress(N, len(idxs), len(idxs),
                     done=True, secs=time.time() - t_bucket)
    if n_fallback:
        print(f"[sweep] {n_fallback} sequences re-folded on the CPU "
              f"parity engine (enumeration/budget flags: {flag_hist})",
              flush=True)
    if stats is not None:
        stats["n_fallback"] = n_fallback
        stats["flag_causes"] = flag_hist
    return results


def write_results_csv(results, path, selection="best_nrj"):
    """Reference result-CSV schema (fft_100n_50ms_scores.csv:1).

    selection: 'best_nrj' = lowest-energy structure (score_best.py),
    'best_of_k' = best-PPV among the saved beam (get_best_score.py)."""
    with open(path, "w") as fh:
        fh.write("seq,len_seq,struct,nrj,nbp,pvv,sens,name\n")
        for r in results:
            if r is None:
                continue
            if selection == "best_of_k" and "struct_bk" in r:
                r = dict(r, struct=r["struct_bk"], nrj=r["nrj_bk"],
                         nbp=r["struct_bk"].count("("),
                         pvv=r["pvv_bk"], sens=r["sens_bk"])
            fh.write("{seq},{len_seq},{struct},{nrj},{nbp},{pvv},{sens},{name}\n"
                     .format(**r))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", required=True, help="benchmark csv (seq,true,name)")
    ap.add_argument("--out", required=True, help="output results csv")
    ap.add_argument("-n", "--n_mode", type=int, default=100)
    ap.add_argument("-ms", "--max_stack", type=int, default=50)
    ap.add_argument("--max_branch", type=int, default=1000)
    ap.add_argument("--limit", type=int, help="only first N records")
    ap.add_argument("--max_len", type=int, help="skip longer sequences")
    ap.add_argument("--min_len", type=int, help="skip shorter sequences "
                    "(split a sweep across engines/hosts by length)")
    ap.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--best_of_k", action="store_true")
    ap.add_argument("--out_bk", help="also write the best-of-k selection CSV")
    ap.add_argument("--devices", type=int, help="data-parallel device count")
    ap.add_argument("--checkpoint", help="bucket-resume journal path")
    ap.add_argument("--fallback-workers", dest="workers", type=int,
                    help="CPU-parity refold pool size (default: all cores)")
    ap.add_argument("--engine", choices=("jax", "cpu"), default="jax",
                    help="'cpu' folds every bucket on the sequential "
                         "parity engine via the process pool (no device)")
    ap.add_argument("--save-beams", dest="save_beams",
                    help="jsonl path: full saved beam per sequence, for "
                         "offline best-of-k re-scoring")
    ap.add_argument("--coordinator",
                    help="host:port of process 0 (multi-host mode)")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    args = ap.parse_args(argv)

    records = load_benchmark_csv(args.csv)
    if args.max_len:
        records = [r for r in records if len(r[0]) <= args.max_len]
    if args.min_len:
        records = [r for r in records if len(r[0]) >= args.min_len]
    if args.limit:
        records = records[: args.limit]

    multihost = args.coordinator is not None
    if multihost:
        from rafft_tpu.parallel.distributed import (init_multihost,
                                                    shard_records)
        pid, pcount, _ld, _gd = init_multihost(
            args.coordinator, args.num_processes, args.process_id)
        print(f"[multihost] process {pid}/{pcount}: "
              f"{len(_ld)} local / {len(_gd)} global devices", flush=True)
        records = shard_records(records, pid, pcount)

    mesh = None
    if args.devices and args.devices > 1:
        from rafft_tpu.parallel.mesh import data_mesh
        mesh = data_mesh(args.devices)

    def progress(N, done_n, total, done=False, secs=None):
        if done:
            peak = (device_peak_bytes() if args.engine == "jax" else None)
            print(f"[bucket {N}] {total} seqs in {secs:.1f}s "
                  f"({total/max(secs,1e-9):.2f} seq/s); device "
                  f"peak_bytes_in_use {peak}", flush=True)

    t0 = time.time()
    stats = {}
    results = sweep(records, nb_mode=args.n_mode, max_stack=args.max_stack,
                    max_branch=args.max_branch,
                    buckets=tuple(int(x) for x in args.buckets.split(",")),
                    batch=args.batch, mesh=mesh, best_of_k=args.best_of_k,
                    progress=progress, checkpoint=args.checkpoint,
                    save_beams=args.save_beams, stats=stats,
                    workers=args.workers, engine=args.engine)
    dt = time.time() - t0
    sel = "best_of_k" if args.best_of_k else "best_nrj"
    # run manifest: the exact configuration + counters that produced the
    # result CSVs (sweeps must not run with unrecorded flags)
    manifest = dict(argv=vars(args), n_records=len(records),
                    elapsed_s=round(dt, 1), **stats)
    with open(f"{args.out}.manifest.json", "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    if multihost:
        # every host writes its part; process 0 merges (shared
        # filesystem, the reference's CSV aggregation model) and the
        # summary metrics reduce over DCN
        from rafft_tpu.parallel.distributed import merge_parts, global_mean
        part = f"{args.out}.part{pid}"
        write_results_csv(results, part, sel)
        with open(part, "a") as fh:
            fh.write("#done\n")
        ok = [r for r in results if r]
        mean_ppv = global_mean(
            float(np.mean([r["pvv"] for r in ok])) if ok else 0.0, len(ok))
        mean_sens = global_mean(
            float(np.mean([r["sens"] for r in ok])) if ok else 0.0, len(ok))
        if pid == 0:
            header = "seq,len_seq,struct,nrj,nbp,pvv,sens,name\n"
            ntot = merge_parts(args.out, pcount, header)
            print(f"{ntot} sequences merged; global mean PPV "
                  f"{mean_ppv:.2f} mean sens {mean_sens:.2f}")
        return
    write_results_csv(results, args.out, sel)
    if args.out_bk:
        write_results_csv(results, args.out_bk, "best_of_k")
    ok = [r for r in results if r]
    mean_ppv = np.mean([r["pvv"] for r in ok]) if ok else 0.0
    mean_sens = np.mean([r["sens"] for r in ok]) if ok else 0.0
    print(f"{len(ok)} sequences in {dt:.1f}s ({len(ok)/dt:.2f} seq/s); "
          f"mean PPV {mean_ppv:.2f} mean sens {mean_sens:.2f}")


if __name__ == "__main__":
    main()
