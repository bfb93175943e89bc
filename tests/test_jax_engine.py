"""Batched JAX engine tests.

These run on the CPU backend (tests/conftest.py sets JAX_PLATFORMS=cpu
with a virtual 8-device mesh); the heavy golden-parity runs live in the
slow markers, and chip_smoke.py runs the engine on the GPU."""

import numpy as np
import pytest

from tests.conftest import reference_available

needs_ref = pytest.mark.skipif(not reference_available(), reason="no reference checkout")


@pytest.fixture(scope="module")
def tiny_engine():
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig

    cfg = EngineConfig(N=32, K=2, R=4, M=8, V=16, CPLX=8, S=64,
                       max_branch=16, max_steps=6)
    return FoldEngine(cfg, B=2)


def test_tiny_fold_matches_cpu(tiny_engine):
    from rafft_tpu.engine.fold_cpu import fold

    seqs = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC"]
    beams, _ = tiny_engine.run(seqs)
    for seq, rows in zip(seqs, beams):
        ref = fold(seq, nb_mode=8, max_stack=2, max_branch=16)
        got = [(db, e) for db, e in rows]
        want = [(s.str_struct, s.energy) for s in ref]
        assert got == want, (seq, got, want)


def test_region_overflow_flagged():
    """A structure needing more loop regions than R slots must raise
    enum_suspect (the sweep then re-folds on the CPU parity engine) —
    never silently drop regions (rafft/utils.py:141-152 semantics)."""
    from rafft_tpu.engine.fold_cpu import fold as cpu_fold
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig

    seq = "GGGGAAAACCCCAAGGGGAAAACCCCAAGGGGAAAACCCC"
    cfg = EngineConfig(N=64, K=4, R=2, M=16, V=64, CPLX=16, S=256,
                       max_branch=64, max_steps=8)
    eng = FoldEngine(cfg, B=1)
    _, state = eng.run([seq])
    assert int(np.asarray(state["enum_suspect"])[0]) > 0

    # with enough slots the same sequence folds exactly and unflagged
    cfg2 = EngineConfig(N=64, K=4, R=8, M=16, V=64, CPLX=16, S=256,
                        max_branch=64, max_steps=8)
    eng2 = FoldEngine(cfg2, B=1)
    beams, state2 = eng2.run([seq])
    assert int(np.asarray(state2["enum_suspect"])[0]) == 0
    want = [(s.str_struct, s.energy)
            for s in cpu_fold(seq, nb_mode=16, max_stack=4, max_branch=64)]
    assert [(db, e) for db, e in beams[0]] == want


def test_incremental_hash_composition():
    """_CHECK_HASH rebuilds every combination pair table the
    pre-incremental way and counts composed-hash mismatches into
    enum_suspect — the flagged counts (and beams) must be identical
    with and without the check, i.e. zero mismatches ever."""
    from rafft_tpu.engine import fold_jax as FJ
    from rafft_tpu.engine.fold_jax import FoldEngine, EngineConfig

    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGU"), int(rng.integers(24, 60))))
            for _ in range(4)]
    cfg = EngineConfig(N=64, K=8, R=8, M=32, V=256, CPLX=64, S=1024,
                      max_branch=256, max_steps=10)
    beams0, st0 = FoldEngine(cfg, B=4).run(seqs)
    FJ._CHECK_HASH = True
    try:
        beams1, st1 = FoldEngine(cfg, B=4).run(seqs)
    finally:
        FJ._CHECK_HASH = False
    assert beams0 == beams1
    np.testing.assert_array_equal(np.asarray(st0["enum_suspect"]),
                                  np.asarray(st1["enum_suspect"]))


def test_sharded_step_runs(tiny_engine):
    import jax

    from rafft_tpu.parallel.mesh import data_mesh, shard_state

    mesh = data_mesh(2)
    seqs = ["GGGAAACCCAAAGGGAAACCC", "GCGCUUCGGCGCGC"]
    state = tiny_engine.init_state(seqs)
    state = shard_state(state, mesh)
    out = tiny_engine._step(state)
    jax.block_until_ready(out["pt"])
    assert bool(np.asarray(out["active"])[:, 0].all())


def test_dryrun_multichip_entry():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@needs_ref
@pytest.mark.slow
def test_jax_engine_golden_ms5():
    from rafft_tpu.engine.fold_jax import fold_one

    golden = open("/root/reference/example/rafft.out").read()
    seq = golden.splitlines()[0]
    res, traj = fold_one(seq, nb_mode=100, max_stack=5, max_branch=1000,
                         traj=True)
    lines = [seq]
    for si, step in enumerate(traj):
        lines.append("# {:-^20}".format(si))
        for st in step:
            lines.append(f"{st.str_struct} {st.energy:6.1f}")
    assert "\n".join(lines) + "\n" == golden
