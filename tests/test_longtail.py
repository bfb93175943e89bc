"""Long-tail (>1024 nt) fold coverage (VERDICT r3 #3).

The corpus tail — the two 23S rRNAs at 2,915/2,968 nt — exceeds the batched
engine's region budget and folds on the sequential CPU parity engine
(rafft_tpu/parallel/sweep.py fallback, tools/fold_longtail.py).  These
tests pin that path:

* a fast test folds a synthetic ~1.2-knt sequence end-to-end and checks
  beam invariants + energy evaluator round-trip;
* a slow test (RAFFT_SLOW=1) re-folds 23s_T.thermophilus at the bench
  config and asserts the committed journal row
  (benchmarks/artifacts/longtail.ckpt.jsonl) is reproduced exactly.
"""

import csv
import json
import os

import pytest

from tests.conftest import reference_available
from rafft_tpu.engine.fold_cpu import fold
from rafft_tpu.energy.eval_np import eval_structure_int

needs_ref = pytest.mark.skipif(not reference_available(),
                               reason="no reference checkout")
ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "artifacts",
    "longtail.ckpt.jsonl")
CORPUS = ("/root/reference/benchmark_results/"
          "benchmark_cleaned_all_length.csv")


def test_fold_beyond_1024nt():
    # deterministic pseudo-random 1,200-nt sequence: hairpin-rich enough
    # to fold several steps
    import numpy as np
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGU"), p=(.3, .2, .2, .3), size=1200))
    structs = fold(seq, nb_mode=20, max_stack=3, max_branch=100)
    assert structs and len(structs) <= 3
    best = structs[0]
    assert len(best.str_struct) == 1200
    assert best.energy <= 0.0
    # energies are sorted ascending and exact under the integer oracle
    es = [s.energy for s in structs]
    assert es == sorted(es)
    for s in structs[:2]:
        e10 = eval_structure_int(seq, s.str_struct)
        assert abs(e10 / 100.0 - s.energy) < 0.005


@needs_ref
@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("RAFFT_SLOW"),
                    reason="~10 min: set RAFFT_SLOW=1")
def test_23s_reproduces_journal_row():
    rows = {}
    with open(ART) as fh:
        for line in fh:
            r = json.loads(line)
            rows[r["name"]] = r
    row = rows["23s_T.thermophilus"]
    seq = row["seq"]
    assert len(seq) == 2915
    structs = fold(seq, nb_mode=100, max_stack=50, max_branch=1000)
    assert structs[0].str_struct == row["struct"]
    assert round(structs[0].energy, 1) == round(row["nrj"], 1)
