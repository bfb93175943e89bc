"""Parity of the lag-indexed wavefront kernel against the FFT + window scan.

The kernel (rafft_tpu/engine/wavefront.py) runs here through the Pallas
interpreter, and compiled on the GPU in the `gpu`-marked test.  It must
equal the gather-based fold_jax._correlate/_window_scan formulation on
every cell the engine consumes, on random region layouts and on layouts
taken from real fold states.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chip_smoke import scan_mismatches
from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.engine import wavefront as WF
from rafft_tpu.engine.fold_jax import EngineConfig, FoldEngine
from rafft_tpu.energy.eval_jax import device_params
from rafft_tpu.scan.encode import weight_matrix


CFG = EngineConfig(N=128, K=2, R=4, M=100)
DP = device_params(37.0, max_len=CFG.N)
W = weight_matrix(3.0, 2.0, 1.0)


def random_regions(rng, K=CFG.K, R=CFG.R, N=CFG.N, n_max=100):
    """Random but engine-valid region layouts: each region is an
    ascending subset of sequence positions (what _regions produces for
    any mix of inner/outer loops), rpos N-padded, rcodes 0-padded."""
    codes_full = rng.integers(0, 5, size=N)
    rpos = np.full((K, R, N), N, dtype=np.int32)
    rcodes = np.zeros((K, R, N), dtype=np.int32)
    mlen = np.zeros((K, R), dtype=np.int32)
    for k in range(K):
        for r in range(R):
            m = int(rng.integers(0, n_max + 1))
            pos = np.sort(rng.choice(n_max, size=m, replace=False))
            rpos[k, r, :m] = pos
            rcodes[k, r, :m] = codes_full[pos]
            mlen[k, r] = m
    return (jnp.asarray(rcodes), jnp.asarray(rpos), jnp.asarray(mlen))


_ZRNG = np.random.default_rng(0xBEEF)
_Z1 = _ZRNG.integers(1, 2**32 - 1, CFG.N + 1, dtype=np.uint64).astype(np.uint32)
_Z2 = _ZRNG.integers(1, 2**32 - 1, CFG.N + 1, dtype=np.uint64).astype(np.uint32)


def _zrows(rpos):
    rp = np.clip(np.asarray(rpos), 0, CFG.N)
    return (jnp.asarray(_Z1[rp].astype(np.int32)),
            jnp.asarray(_Z2[rp].astype(np.int32)))


def _compare(rcodes, rpos, mlen, cfg=CFG, interpret=True):
    """Wavefront kernel against the FFT + window scan on the cells the
    step consumes; returns the reference and its mask."""
    z1row, z2row = _zrows(rpos)

    def run(path):
        return jax.jit(lambda *a: FJ.scan_tables(cfg, DP, W, *a, path,
                                                 interpret=interpret))(
            rcodes, rpos, mlen, z1row, z2row)

    ref = run("fft")
    bad, cells = scan_mismatches(ref, run("wavefront"))
    assert not bad, bad
    mask = np.asarray(ref[3]) & (np.asarray(ref[4]["max_nb"]) > 0)
    assert cells == int(mask.sum())
    return ref, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wavefront_matches_window_scan(seed):
    rng = np.random.default_rng(seed)
    rcodes, rpos, mlen = random_regions(rng)
    (_, _, _, _, ws1), mask = _compare(rcodes, rpos, mlen)
    assert mask.any()

    # hash deltas must equal the brute-force recomputation from the
    # winning stems: sum over the stem's pairs of Z1[p5](p3+1)+Z1[p3](p5+1)
    rposn = np.asarray(rpos)
    i_s = np.asarray(ws1["max_i"])
    j_s = np.asarray(ws1["max_j"])
    run = np.asarray(ws1["max_nb"])
    hd1 = np.asarray(ws1["hd1"]).astype(np.uint32)
    kk, rr, mm = np.nonzero(mask)
    for k, r, m in list(zip(kk, rr, mm))[:50]:
        acc = 0
        for t in range(run[k, r, m]):
            p5 = int(rposn[k, r, i_s[k, r, m] - t])
            p3 = int(rposn[k, r, j_s[k, r, m] + t])
            acc = (acc + int(_Z1[p5]) * (p3 + 1)
                   + int(_Z1[p3]) * (p5 + 1)) & 0xFFFFFFFF
        assert acc == int(hd1[k, r, m]), (k, r, m)


def _tiny_layout():
    """Degenerate layouts: empty regions, single positions, a full
    contiguous region and a region as long as the bucket."""
    K, R, N = CFG.K, CFG.R, CFG.N
    rpos = np.full((K, R, N), N, dtype=np.int32)
    rcodes = np.zeros((K, R, N), dtype=np.int32)
    mlen = np.zeros((K, R), dtype=np.int32)
    rng = np.random.default_rng(7)
    # k0,r0: the whole 0..79 contiguous region (step-0 layout)
    rpos[0, 0, :80] = np.arange(80)
    rcodes[0, 0, :80] = rng.integers(1, 5, size=80)
    mlen[0, 0] = 80
    # k0,r1: single position; k1,r0: two adjacent positions
    rpos[0, 1, 0] = 5
    rcodes[0, 1, 0] = 2
    mlen[0, 1] = 1
    rpos[1, 0, :2] = [10, 11]
    rcodes[1, 0, :2] = [1, 2]
    mlen[1, 0] = 2
    # k1,r3: a region filling the whole bucket
    rpos[1, 3] = np.arange(N)
    rcodes[1, 3] = rng.integers(1, 5, size=N)
    mlen[1, 3] = N
    return jnp.asarray(rcodes), jnp.asarray(rpos), jnp.asarray(mlen)


def test_wavefront_empty_and_tiny_regions():
    _compare(*_tiny_layout())


def fold_state_layouts(cfg, seqs, steps):
    """Region layouts of real fold states: the batch after `steps` fold
    steps, as (rcodes, rpos, mlen) per sequence, [B, K, R, N] each."""
    eng = FoldEngine(cfg, B=len(seqs))
    state = eng.init_state(seqs)
    for _ in range(steps):
        state = eng._step(state)
    lay = jax.jit(jax.vmap(eng.region_layout))(
        state["codes"], state["n"], state["pt"], state["rorder"])
    return lay["rcodes"], lay["rpos"], lay["mlen"]


def test_wavefront_on_fold_states():
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGU"), int(rng.integers(60, 120))))
            for _ in range(2)]
    cfg = EngineConfig(N=128, K=4, R=8, M=100, V=64, CPLX=32, S=512,
                       max_branch=64, max_steps=6)
    rc, rp, ml = fold_state_layouts(cfg, seqs, steps=2)
    for b in range(len(seqs)):
        _compare(rc[b], rp[b], ml[b], cfg=cfg)


def test_vmapped_kernel_matches_per_sequence():
    """vmap extends the kernel's grid by the batch (the engine calls it
    inside its vmapped step)."""
    rng = np.random.default_rng(6)
    lays = [random_regions(rng) for _ in range(2)]
    lays = [lay + _zrows(lay[1]) for lay in lays]
    batched = [jnp.stack(x) for x in zip(*lays)]
    run = lambda *a: WF.wavefront_tables(CFG, DP, W, *a, interpret=True)
    got = jax.jit(jax.vmap(run))(*batched)
    for b, lay in enumerate(lays):
        want = jax.jit(run)(*lay)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key][b]),
                                          np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("N,integral,ok", [
    (32, True, False), (64, True, False), (128, True, True),
    (256, True, True), (1024, True, True), (2048, True, True),
    (4096, True, True), (96, True, False),
    (384, True, False), (128, False, False)])
def test_wavefront_gate(N, integral, ok):
    assert WF.supported(EngineConfig(N=N), integral) is ok


@pytest.mark.parametrize("N,gc,backend,path", [
    (32, 3.0, "gpu", "fft"), (64, 3.0, "gpu", "fft"),
    (128, 3.0, "gpu", "wavefront"), (512, 3.0, "gpu", "wavefront"),
    (128, 2.5, "gpu", "fft"), (128, 3.0, "cpu", "fft"),
    (512, 3.0, "cpu", "fft")])
def test_engine_picks_scan_path(monkeypatch, N, gc, backend, path):
    """The kernel compiles for the GPU only; elsewhere, and outside its
    shape limits, the engine takes the FFT + window scan."""
    monkeypatch.setattr(FJ.jax, "default_backend", lambda: backend)
    cfg = EngineConfig(N=N, K=2, R=4, M=min(16, 2 * N - 1), V=16, CPLX=8,
                       S=64, gc_wei=gc)
    assert FoldEngine(cfg, B=1).scan_path == path


@pytest.mark.gpu
def test_wavefront_kernel_on_gpu(gpu):
    """On the card: the compiled kernel equals the FFT + window scan on
    random layouts and on the degenerate ones."""
    _compare(*random_regions(np.random.default_rng(3)), interpret=False)
    _compare(*_tiny_layout(), interpret=False)
