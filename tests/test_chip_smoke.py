"""chip_smoke.py's CPU-checkable parts: sampling, layouts, beam parity
helpers, and its refusal to report without a GPU."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import chip_smoke as CS


@pytest.fixture(scope="module")
def corpus():
    return CS.load_corpus()


def test_corpus_is_the_committed_csv(corpus):
    assert len(corpus) == 2296
    assert all(set(s) <= set("ACGU") for s, _, _ in corpus)


@pytest.mark.parametrize("N", CS.BUCKETS)
def test_bucket_sample_is_seeded_and_in_bucket(corpus, N):
    a = CS.bucket_sample(corpus, N, 12)
    assert a == CS.bucket_sample(corpus, N, 12)
    assert a != CS.bucket_sample(corpus, N, 12, seed=CS.SEED + 1)
    lo = max([b for b in CS.BUCKETS if b < N], default=0)
    assert len(a) == 12 and all(lo < len(s) <= N for s, _, _ in a)


@pytest.mark.parametrize("first_step", [False, True])
def test_synthetic_layout_is_engine_valid(first_step):
    B, K, R, N = 2, 3, 4, 128
    rc, rp, ml, z1, z2 = CS.synthetic_layout(np.random.default_rng(0), B, K,
                                             R, N, first_step=first_step)
    assert rc.shape == rp.shape == z1.shape == (B, K, R, N)
    assert ml.shape == (B, K, R)
    for b in range(B):
        seen = []
        for k in range(K):
            for r in range(R):
                m = ml[b, k, r]
                assert np.all(np.diff(rp[b, k, r, :m]) > 0)
                assert np.all(rp[b, k, r, m:] == N)
                assert np.all(rc[b, k, r, m:] == 0)
                assert np.all((rc[b, k, r, :m] >= 1) & (rc[b, k, r, :m] <= 4))
            # regions of one beam row partition its unpaired positions
            pos = np.concatenate([rp[b, k, r, :ml[b, k, r]]
                                  for r in range(R)])
            assert len(pos) == len(set(pos.tolist()))
            seen.append(len(pos))
        if first_step:
            assert seen[0] > N // 2 and not any(seen[1:])


@pytest.mark.parametrize("c", [1, 4, 6, 7])
def test_beam_chunks_cover_every_row_once(c):
    B, K, R, N = 2, 3, 4, 128
    lay = CS.synthetic_layout(np.random.default_rng(1), B, K, R, N)
    chunks = CS.beam_chunks(lay, c, N)
    assert len(chunks) == -(-B * K // c)
    for ch in chunks:
        assert [x.shape for x in ch] == [(c, R, N), (c, R, N), (c, R),
                                         (c, R, N), (c, R, N)]
    for x, y, fill in zip(lay, zip(*chunks), (0, N, 0, 0, 0)):
        y = np.concatenate(y)
        np.testing.assert_array_equal(y[:B * K], x.reshape(y[:B * K].shape))
        assert np.all(y[B * K:] == fill)


def test_fft_chunk_fits_its_budget():
    from rafft_tpu.parallel.sweep import bucket_config

    for N in CS.BUCKETS:
        cfg = bucket_config(N)
        c = CS.fft_chunk(cfg)
        per_row = cfg.R * (N // 2 + 1) * N * CS.FFT_STACK_BYTES
        assert c >= 1 and (c == 1 or c * per_row <= CS.FFT_CHUNK_BUDGET)
    # about 40 GB per K=50 sequence at the 1024 bucket
    assert 35e9 < 50 * CS.FFT_STACK_BYTES * 32 * 513 * 1024 < 45e9


def test_check_scans_in_chunks(monkeypatch):
    """check_scans at tiny size, with the kernel interpreted and chunks
    of 3 beam rows (the last one padded)."""
    from rafft_tpu.engine import fold_jax as FJ
    from rafft_tpu.engine import wavefront as WF

    monkeypatch.setattr(FJ, "wavefront_tables", lambda *a, interpret:
                        WF.wavefront_tables(*a, interpret=True))
    monkeypatch.setattr(CS, "fft_chunk", lambda cfg: 3)
    cfg = FJ.EngineConfig(N=128, K=2, R=4, M=100)
    lay = CS.synthetic_layout(np.random.default_rng(2), 2, 2, 4, 128)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        CS.check_scans(cfg, lay, "tiny")
    assert "all 2 chunks of 3 beam rows" in out.getvalue()


def test_beam_mismatches():
    want = {0: [("((...))", -1.2)], 1: [("....", 0.0)]}
    assert CS.beam_mismatches(want, want) == []
    got = {0: [("((...))", np.float32(-1.2))], 1: [("(..)", 0.0)]}
    assert CS.beam_mismatches(got, want) == [1]
    assert CS.beam_mismatches({0: want[0]}, want) == [1]


def test_committed_beams_lookup(corpus):
    seqs = [s for s, _, _ in corpus[:5]]
    com = CS.committed_beams(seqs)
    assert set(com) <= set(seqs) and com
    for rows in com.values():
        assert all(len(db) == len(rows[0][0]) for db, _ in rows)


def test_tiny_fold_parity_helpers(corpus):
    """The parity chain at tiny size: batched beams against the CPU
    engine through the refold task function."""
    from rafft_tpu.engine.fold_jax import EngineConfig, FoldEngine
    from rafft_tpu.parallel.sweep import _cpu_refold

    seqs = [s for s, _, _ in CS.bucket_sample(corpus, 128, 2)]
    cfg = EngineConfig(N=128, K=2, R=8, M=16, V=64, CPLX=32, S=512,
                       max_branch=32)
    got = {i: rows for i, rows, flag in
           FoldEngine(cfg, B=2).run_stream(seqs) if not flag}
    want = dict(_cpu_refold((i, seqs[i], 16, 2, 32)) for i in got)
    assert got and CS.beam_mismatches(got, want) == []


def test_main_refuses_a_cpu_device():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ei:
        CS.main([])
    assert ei.value.code not in (0, None)
    assert '"ok"' not in out.getvalue()


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero without a verdict."""
    import shutil
    import subprocess
    import sys

    shutil.copy(CS.__file__, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu",
                                  PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    with pytest.raises(ValueError):
        json.loads(out.stdout.strip().splitlines()[-1] if out.stdout.strip()
                   else "")
