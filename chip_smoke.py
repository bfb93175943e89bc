#!/usr/bin/env python3
"""Smoke test of the batched fold engine on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py            # every phase below, on one card
    python chip_smoke.py --four     # only the 4-card sweep against 1 card

Phases, all in this one process (the CPU refold pool stays off the card):

1. device: JAX's default device must be a GPU; prints the JAX version,
   the compile-cache directory and the card's name and power limit.
2. native: builds the Turner evaluator from source if needed and names
   the evaluator the sequential CPU engine uses.
3. kernel: the wavefront kernel at N=128/256/512/1024 with each bucket's
   batch, beam width and region slots, on synthetic mid-fold and
   first-step region layouts: compiled memory analysis and time at full
   width; every consumed cell of every beam row equal to the FFT +
   window scan, run in chunks of beam rows that fit its Hankel stacks;
   both timed on one such chunk.
4. main path: per bucket, a seeded corpus sample of 3*B sequences
   through FoldEngine.run_stream at the sweep's configuration (-n 100
   -ms 50): compile seconds, memory analysis, flagged causes, a smoke
   fold rate; the kernel against the FFT scan on the region layouts of
   real fold states; every unflagged beam of a seeded
   subset equal to the sequential CPU engine, refolded through the
   sweep's refold pool.
5. CLI: the README quick start through rafft_tpu.cli (-ms 5 and -ms 20
   with --traj), --engine jax byte-identical to --engine cpu, then
   rafft_kin on the -ms 20 output.
6. MFE: the batched JAX DP on 8 seeded sequences equals the native DP.

Any failure exits non-zero without the verdict.  The last line of
standard output is the verdict:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import gzip
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ART = os.path.join(ROOT, "benchmarks", "artifacts")
CORPUS_CSV = os.path.join(ART, "fft_100n_50ms_scores.csv")
COMMITTED_BEAMS = os.path.join(ART, "beams_100n50.jsonl.gz")
OUT = os.path.join(ROOT, "build", "smoke")

BUCKETS = (128, 256, 512, 1024)
PARITY_SEQS = {128: 16, 256: 8, 512: 4, 1024: 2}
FOUR_BUCKETS = (128, 512)
SEED = 20261016
# the README's quick-start sequence (82-nt frameshift element); its
# golden best energy at -ms 5 is -24.0 kcal/mol
README_SEQ = ("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGGCACUAGUACUGAU"
              "GUCGUAUACAGGGCUUUUGACAU")
GOLDEN_BEST = -24.0


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query, what="--query-gpu"):
    out = subprocess.run(["nvidia-smi", f"{what}={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout.strip() if out.returncode == 0
            else f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------- inputs

def load_corpus(path=CORPUS_CSV):
    """Corpus rows (seq, true_struct, name) of the committed CSV."""
    with open(path) as fh:
        return [(r["seq"], r["struct"], r["name"])
                for r in csv.DictReader(fh)]


def bucket_sample(records, N, n, seed=SEED):
    """A seeded sample of n records whose length falls in bucket N (above
    the next smaller bucket), in corpus order."""
    lo = max([b for b in BUCKETS if b < N], default=0)
    idx = [i for i, r in enumerate(records) if lo < len(r[0]) <= N]
    rng = np.random.default_rng(seed + N)
    pick = np.sort(rng.choice(len(idx), size=min(n, len(idx)),
                              replace=False))
    return [records[idx[i]] for i in pick]


def synthetic_layout(rng, B, K, R, N, first_step=False):
    """Region layouts [B, K, R, N] at a bucket's real widths.

    Mid-fold: each beam row keeps a random share of a random-length
    sequence unpaired, split over 1..R regions.  First step: only beam
    row 0 is live, holding the whole sequence as one region."""
    rpos = np.full((B, K, R, N), N, np.int32)
    rcodes = np.zeros((B, K, R, N), np.int32)
    mlen = np.zeros((B, K, R), np.int32)
    for b in range(B):
        n = int(rng.integers(N // 2 + 1, N + 1))
        codes = rng.integers(1, 5, size=n)
        for k in range(1 if first_step else K):
            if first_step:
                pos, lab, live = np.arange(n), np.zeros(n, int), 1
            else:
                u = int(rng.integers(n // 4, n + 1))
                pos = np.sort(rng.choice(n, size=u, replace=False))
                live = int(rng.integers(1, R + 1))
                lab = rng.integers(0, live, size=u)
            for r in range(live):
                p = pos[lab == r]
                rpos[b, k, r, :len(p)] = p
                rcodes[b, k, r, :len(p)] = codes[p]
                mlen[b, k, r] = len(p)
    z = rng.integers(-2**31, 2**31 - 1, size=(2, B, K, R, N), dtype=np.int64)
    return rcodes, rpos, mlen, z[0].astype(np.int32), z[1].astype(np.int32)


def beam_rows(rows):
    """Canonical beam rows [(dot_bracket, energy)] for equality tests."""
    return [(db, float(np.float32(e))) for db, e in rows]


def beam_mismatches(got, want):
    """Keys whose beams differ between two {key: rows} maps (keys of
    `want` only)."""
    return sorted(k for k in want
                  if beam_rows(got.get(k, [])) != beam_rows(want[k]))


def committed_beams(seqs, path=COMMITTED_BEAMS):
    """{seq: rows} of the committed sweep beams for the given sequences."""
    want, out = set(seqs), {}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            row = json.loads(line)
            if row["seq"] in want:
                out[row["seq"]] = row["beam"]
    return out


# ---------------------------------------------------------------- timing

def compile_timed(fn, *args):
    """(compiled, seconds) of jit(fn) at args."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def run_timed(compiled, *args, reps=5):
    """(outputs, median seconds) over reps runs after one warm run."""
    import jax
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def mem_summary(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    return (f"args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes}"
            f" B, temp {m.temp_size_in_bytes} B, code "
            f"{m.generated_code_size_in_bytes} B")


# ---------------------------------------------------------------- phases

def phase_device(count=1):
    import jax
    from rafft_tpu import jax_setup

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"{count} GPUs needed, JAX sees {len(devs)}")
    card = nvidia_smi("name,power.limit").splitlines()[0]
    if card.startswith("nvidia-smi failed"):
        raise SystemExit(card)
    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(set by {'this repo' if jax_setup.cache_dir() else 'env'})")
    log(card)
    return devs, card


def phase_native():
    from rafft_tpu.native.build import build
    from rafft_tpu.native import native_oracle

    t0 = time.perf_counter()
    path = build()
    ok = native_oracle() is not None
    log(f"native library {path} ready in {time.perf_counter() - t0:.1f} s; "
        f"CPU engine evaluator: {'native C++' if ok else 'pure Python'}")
    if not ok:
        raise RuntimeError("native evaluator unavailable")


SCAN_FIELDS = ("max_nb", "max_i", "max_j", "best_sE", "hd1", "hd2")
# bytes the FFT scan's Hankel stacks take per beam row and lag step:
# code/position (2) and hash halves (4) in forward and backward f32 stacks
FFT_STACK_BYTES = 4 * 2 * (2 + 4)
FFT_CHUNK_BUDGET = 4 << 30


def scan_mismatches(a, b):
    """Fields on which two fold_jax.scan_tables results differ where the
    step consumes them: cor, lags and lag_ok everywhere, the window-scan
    fields at selected, populated lags.  Returns (names, cells)."""
    (c1, l1, _, o1, w1), (c2, l2, _, o2, w2) = a, b
    bad = [k for k, x, y in (("cor", c1, c2), ("lags", l1, l2),
                             ("lag_ok", o1, o2))
           if not np.array_equal(np.asarray(x), np.asarray(y))]
    mask = np.asarray(o1) & (np.asarray(w1["max_nb"]) > 0)
    bad += [k for k in SCAN_FIELDS
            if not np.array_equal(np.asarray(w1[k])[mask],
                                  np.asarray(w2[k])[mask])]
    return bad, int(mask.sum())


def fft_chunk(cfg, budget=FFT_CHUNK_BUDGET):
    """Beam rows per FFT-scan call: its Hankel stacks take
    R * (N/2+1) * N * FFT_STACK_BYTES per beam row, which at full width
    (K=50, R=32, N=1024) is about 40 GB per sequence."""
    per_row = cfg.R * (cfg.N // 2 + 1) * cfg.N * FFT_STACK_BYTES
    return max(1, budget // per_row)


def beam_chunks(layout, c, N):
    """Split [B, K, R, N] region layouts (rcodes, rpos, mlen, z1row,
    z2row) into chunks of c beam rows over the flattened (b, k) rows; the
    last chunk is padded with empty rows (mlen 0, rpos N)."""
    flat = [np.asarray(x).reshape((-1,) + np.shape(x)[2:]) for x in layout]
    pad = -len(flat[0]) % c
    flat = [np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
            for x, fill in zip(flat, (0, N, 0, 0, 0))]
    return [[x[i:i + c] for x in flat] for i in range(0, len(flat[0]), c)]


@functools.lru_cache(maxsize=None)
def _scan_fns(cfg, c):
    """jit-compiled wavefront-kernel and FFT scan_tables on one chunk of
    c beam rows (a sequence of K=c), one pair per bucket and chunk."""
    import jax
    from rafft_tpu.engine import fold_jax as FJ
    from rafft_tpu.energy.eval_jax import device_params
    from rafft_tpu.scan.encode import weight_matrix

    ccfg = dataclasses.replace(cfg, K=c)
    dp = device_params(cfg.temp, max_len=cfg.N)
    W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
    return {path: jax.jit(lambda *a, p=path: FJ.scan_tables(
        ccfg, dp, W, *a, p)) for path in ("wavefront", "fft")}


def check_scans(cfg, layout, label, card=None):
    """The compiled kernel against the FFT + window scan on the consumed
    cells of every beam row of `layout`, in chunks that fit the FFT
    scan's Hankel stacks; with `card`, also times both on one chunk."""
    c = min(fft_chunk(cfg), int(np.prod(np.shape(layout[2])[:2])))
    fns = _scan_fns(cfg, c)
    chunks = beam_chunks(layout, c, cfg.N)
    cells = 0
    for i, ch in enumerate(chunks):
        got = fns["wavefront"](*ch)
        bad, n = scan_mismatches(fns["fft"](*ch), got)
        if bad:
            raise AssertionError(f"{label}: kernel != FFT scan on {bad} in "
                                 f"chunk {i} of {c} beam rows")
        cells += n
    log(f"  {label}: kernel == FFT scan on {cells} consumed cells of all "
        f"{len(chunks)} chunks of {c} beam rows")
    if card:
        t = {path: run_timed(fn, *chunks[0])[1] for path, fn in fns.items()}
        log(f"  {label}: scan_tables on {c} beam rows: kernel "
            f"{t['wavefront'] * 1e3:.3f} ms, FFT scan {t['fft'] * 1e3:.3f} "
            f"ms per call ({card})")


def phase_kernel(card):
    import jax
    import jax.numpy as jnp
    from rafft_tpu.engine.wavefront import wavefront_tables
    from rafft_tpu.energy.eval_jax import device_params
    from rafft_tpu.parallel.sweep import bucket_batch, bucket_config
    from rafft_tpu.scan.encode import weight_matrix

    rng = np.random.default_rng(SEED)
    for N in BUCKETS:
        cfg = bucket_config(N)
        B = bucket_batch(16, N)
        dp = device_params(cfg.temp, max_len=N)
        W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
        tables = jax.vmap(lambda *a: wavefront_tables(cfg, dp, W, *a))
        log(f"[kernel N={N}] B={B} K={cfg.K} R={cfg.R}")
        for kind in ("mid-fold", "first-step"):
            layout = [jnp.asarray(x) for x in synthetic_layout(
                rng, B, cfg.K, cfg.R, N, first_step=kind == "first-step")]
            comp, secs = compile_timed(tables, *layout)
            if kind == "mid-fold":
                log(f"  kernel compiled in {secs:.1f} s; {mem_summary(comp)}")
            _, t = run_timed(comp, *layout)
            log(f"  {kind}: kernel {t * 1e3:.3f} ms per call at full width "
                f"({card})")
            check_scans(cfg, layout, kind, card)


def phase_main(pool, card):
    import jax
    from rafft_tpu.engine.fold_jax import FoldEngine
    from rafft_tpu.parallel.sweep import (FLAG_NAMES, _cpu_refold,
                                          bucket_batch, bucket_config,
                                          device_peak_bytes)

    records = load_corpus()
    refolds = []
    for N in BUCKETS:
        cfg = bucket_config(N)
        B = bucket_batch(16, N)
        sample = bucket_sample(records, N, 3 * B)
        seqs = [r[0] for r in sample]
        log(f"[bucket {N}] B={B} K={cfg.K} R={cfg.R} M={cfg.M} V={cfg.V} "
            f"W={cfg.W} CPLX={cfg.CPLX} S={cfg.S}; {len(seqs)} sequences "
            f"of {min(map(len, seqs))}-{max(map(len, seqs))} nt")
        eng = FoldEngine(cfg, B=B)
        state = eng.init_state(seqs[:B], seqids=list(range(B)))
        t0 = time.perf_counter()
        advance = eng._advance.lower(state, 4).compile()
        log(f"  _advance compiled in {time.perf_counter() - t0:.1f} s; "
            f"{mem_summary(advance)}")

        # the kernel on the region layouts of real fold states
        lay_fn = jax.jit(jax.vmap(eng.region_layout))
        for step in (0, 4, 8):
            lay = lay_fn(state["codes"], state["n"], state["pt"],
                         state["rorder"])
            check_scans(cfg, [lay[k] for k in ("rcodes", "rpos", "mlen",
                                               "z1row", "z2row")],
                        f"fold state after {step} steps")
            state = advance(state)

        t0 = time.perf_counter()
        folded = {i: (rows, flag) for i, rows, flag in eng.run_stream(seqs)}
        secs = time.perf_counter() - t0
        assert sorted(folded) == list(range(len(seqs))), sorted(folded)
        causes = {}
        for _, flag in folded.values():
            for bit, name in FLAG_NAMES.items():
                if flag & bit:
                    causes[name] = causes.get(name, 0) + 1
        nflag = sum(1 for _, f in folded.values() if f)
        log(f"  run_stream: {len(seqs)} folds in {secs:.2f} s = "
            f"{len(seqs) / secs:.3f} folds/s (smoke figure, first call "
            f"after compile; {card}); flagged {nflag}/{len(seqs)} = "
            f"{nflag / len(seqs):.3f} {causes}; device peak_bytes_in_use "
            f"{device_peak_bytes()} (process peak so far)")

        unflagged = [i for i, (_, f) in folded.items() if not f]
        rng = np.random.default_rng(SEED + 7 * N)
        pick = sorted(rng.choice(unflagged, size=min(PARITY_SEQS[N],
                                                     len(unflagged)),
                                 replace=False).tolist())
        tasks = [(i, seqs[i], 100, cfg.K, cfg.max_branch) for i in pick]
        refolds.append((N, cfg.K, {i: folded[i][0] for i in pick}, seqs,
                        pool.map_async(_cpu_refold, tasks)))

    log("[parity] waiting for the CPU refolds; processes on the card: "
        + (nvidia_smi("pid", "--query-compute-apps").replace("\n", ", ")
           or "none"))
    for N, K, got, seqs, res in refolds:
        want = dict(res.get(timeout=1800))
        bad = beam_mismatches(got, want)
        com = committed_beams([seqs[i] for i in got])
        same = sum(1 for i in got if seqs[i] in com
                   and beam_rows(com[seqs[i]]) == beam_rows(got[i]))
        log(f"  bucket {N}: {len(want) - len(bad)}/{len(want)} sampled "
            f"unflagged K={K} beams equal the CPU engine; {same}/{len(got)} "
            f"equal the committed beams_100n50 rows (informational)")
        if bad:
            raise AssertionError(f"bucket {N}: beams differ from the CPU "
                                 f"engine for sample indices {bad}")


def phase_cli():
    from rafft_tpu.cli import fold_cli, kin_cli

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue()

    os.makedirs(OUT, exist_ok=True)
    for ms in (5, 20):
        argv = ["-s", README_SEQ, "-ms", str(ms), "--traj"]
        t0 = time.perf_counter()
        got = run(fold_cli.main, argv + ["--engine", "jax"])
        secs = time.perf_counter() - t0
        want = run(fold_cli.main, argv + ["--engine", "cpu"])
        if got != want:
            raise AssertionError(f"-ms {ms}: --engine jax output differs "
                                 f"from --engine cpu")
        best = min(float(line.split()[-1]) for line in got.splitlines()
                   if line[:1] in ".(")
        log(f"[cli -ms {ms} --traj] jax == cpu byte for byte "
            f"({len(got.splitlines())} lines, {secs:.1f} s with compile); "
            f"best energy {best}")
        if ms == 5 and best != GOLDEN_BEST:
            raise AssertionError(f"best energy {best} != {GOLDEN_BEST}")
        path = os.path.join(OUT, f"rafft_{ms}.out")
        with open(path, "w") as fh:
            fh.write(got)
    kin = run(kin_cli.main, [path]).splitlines()
    if not kin:
        raise AssertionError("rafft_kin printed nothing")
    log(f"[cli rafft_kin] {len(kin)} lines; last: {kin[-1]}")


def phase_mfe():
    from rafft_tpu.mfe import mfe_fold
    from rafft_tpu.mfe.mfe_jax import mfe_batch

    rng = np.random.default_rng(SEED)
    short = [r[0] for r in load_corpus() if len(r[0]) <= 150]
    seqs = [short[i] for i in rng.choice(len(short), 8, replace=False)]
    got = mfe_batch(seqs)
    for s, (db, e) in zip(seqs, got):
        db2, e2 = mfe_fold(s)
        if db != db2 or abs(e - e2) > 1e-9:
            raise AssertionError(f"MFE differs on {s}: {(db, e)} vs "
                                 f"{(db2, e2)}")
    log(f"[mfe] batched JAX DP == native DP on {len(seqs)} sequences of "
        f"{min(map(len, seqs))}-{max(map(len, seqs))} nt")


def phase_four(card):
    """The 128 and 512 buckets through sweep() on a 4-card data mesh,
    against the same folds on one card."""
    from rafft_tpu.parallel.mesh import data_mesh
    from rafft_tpu.parallel.sweep import bucket_batch, sweep

    records = load_corpus()
    os.makedirs(OUT, exist_ok=True)
    for N in FOUR_BUCKETS:
        sample = bucket_sample(records, N, 2 * bucket_batch(16, N))
        beams = {}
        for cards in (1, 4):
            path = os.path.join(OUT, f"four_{N}_{cards}.jsonl")
            if os.path.exists(path):
                os.unlink(path)
            stats = {}
            t0 = time.perf_counter()
            sweep(sample, buckets=(N,), mesh=data_mesh(cards) if cards > 1
                  else None, save_beams=path, stats=stats)
            with open(path) as fh:
                beams[cards] = {r["name"]: (r["flagged"], r["beam"])
                                for r in map(json.loads, fh)}
            log(f"[four N={N}] {cards} card(s): {len(beams[cards])} folds "
                f"in {time.perf_counter() - t0:.1f} s with compile; "
                f"flagged {stats.get('n_fallback')} ({card})")
        bad = [k for k in beams[1] if beams[4].get(k) != beams[1][k]]
        if bad or len(beams[4]) != len(beams[1]):
            raise AssertionError(f"N={N}: 4-card beams differ on {bad}")
        log(f"[four N={N}] 4-card beams == 1-card beams on all "
            f"{len(beams[1])} sequences")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-card sweep against one card")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    t_all = time.perf_counter()
    devs, card = phase_device(count)
    if args.four:
        phase_four(card)
    else:
        from rafft_tpu.parallel.sweep import refold_pool

        phase_native()
        phase_kernel(card)
        with refold_pool(max(1, min(14, (os.cpu_count() or 2) - 2))) as pool:
            phase_main(pool, card)
        phase_cli()
        phase_mfe()
    log(f"all phases passed in {time.perf_counter() - t_all:.0f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
