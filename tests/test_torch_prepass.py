"""Prepass (-p) parity: `burst_tpu_torch.prepass.run_prepass` on the CPU
(plain kernel versions) against `burst_tpu.prepass.run_prepass` on
jax-CPU, exact bytes: BEST with both strands (-fr), ALLPATHS, FORAGE,
CAPITALIST with a taxonomy and ANY, the heuristic cut (-hr) on and off,
ITER 16 and 32, and one case under a forced budget (K2 over tile slabs,
at least 3 a bucket). The batch is made as the CLI makes it for -p:
without RC twins. The golden prepass tests need the reference binary;
these need only burst_tpu."""
import io

import numpy as np
import pytest
import torch

from burst_tpu import prepass as jprepass
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix as jscore_matrix
from burst_tpu.io.taxonomy import Taxonomy as JTaxonomy
from burst_tpu.process import process_queries as jprocess_queries
from burst_tpu.process import process_references
from burst_tpu_torch import engine, prepass
from burst_tpu_torch.alphabet import score_matrix
from burst_tpu_torch.io.taxonomy import Taxonomy
from burst_tpu_torch.process import process_queries
from burst_tpu_torch.state import from_reference, load_db

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
THRES = 0.97
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module")
def work():
    """20 families x 4 members x 800 bp, 200 reads of 100 bp with 0-2
    substitutions, a third of them reverse complemented, every 37th with
    an N; a taxonomy over the references."""
    rng = np.random.default_rng(7)
    refs, rheads = [], []
    for f in range(20):
        anc = rng.choice(BASES, 800)
        for m in range(4):
            r = anc.copy()
            pos = rng.integers(0, 800, 8)
            r[pos] = BASES[rng.integers(0, 4, 8)]
            refs.append(r)
            rheads.append(b"f%02dm%d" % (f, m))
    reads, heads = [], []
    for i in range(200):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, 700))
        r = s[st:st + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 100))] = BASES[int(rng.integers(0, 4))]
        if i % 3 == 0:
            r = np.frombuffer(r[::-1].tobytes().translate(COMP),
                              np.uint8).copy()
        if i % 37 == 0:
            r[5] = ord("N")
        reads.append(r)
        heads.append(b"q%03d" % i)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=100, thres=THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    tax = [(h, b"k__K;p__P%d;c__C%d" % (int(h[1:3]) % 3, int(h[1:3])))
           for h in rheads]
    prd, pacc = from_reference(rd, acc)
    db = load_db(prd, pacc, score_matrix(), "cpu")
    return dict(rd=rd, acc=acc, heads=heads, reads=reads, prd=prd,
                pacc=pacc, db=db, jtax=JTaxonomy(tax), ptax=Taxonomy(tax))


def _both(work, a, tax=False, db=None, spy=None):
    """(burst_tpu's bytes, the port's bytes) of one prepass run."""
    jqd = jprocess_queries(work["heads"], [r.copy() for r in work["reads"]],
                           THRES, False)
    ref = io.StringIO()
    assert jprepass.run_prepass(
        jqd, work["rd"], work["acc"], dict(a, smat=jscore_matrix()), ref,
        work["jtax"] if tax else None) == 101
    pqd = process_queries(work["heads"], [r.copy() for r in work["reads"]],
                          THRES, False)
    got = io.StringIO()
    pa = dict(a) if spy is None else dict(a, _pairs_ed_fn=spy)
    assert prepass.run_prepass(pqd, db or work["db"], work["pacc"], pa, got,
                               work["ptax"] if tax else None) == 101
    return ref.getvalue(), got.getvalue()


@pytest.mark.parametrize("mode,iters,rc,heur", [
    ("BEST", 16, True, False),
    ("BEST", 32, True, True),
    ("ALLPATHS", 16, True, False),
    ("FORAGE", 32, True, False),
    ("CAPITALIST", 32, True, True),
    ("ANY", 16, False, False),
])
def test_prepass_matches_jax(work, mode, iters, rc, heur):
    a = dict(mode=mode, prepass=iters, rc=rc, heur=heur)
    ref, got = _both(work, a, tax=(mode == "CAPITALIST"))
    assert got == ref
    assert got.count("\n") >= (150 if rc else 100)
    if mode == "CAPITALIST":
        assert "k__K;p__P" in got


def test_prepass_under_a_forced_budget(work):
    """The tables resident, every tile bucket streamed: K2 runs over
    tile slabs, at least 3 a bucket; the bytes do not change."""
    plan = work["db"].plan
    lbs, counts = np.unique(engine._unit_lb(work["prd"]), return_counts=True)
    slot = max(8 * 960, min(int(n) // 3 * (int(lb) + engine.A_PAD)
                            for lb, n in zip(lbs, counts)))
    budget = score_matrix().nbytes + plan.pieces[("tables",)] + 2 * slot
    db = load_db(work["prd"], work["pacc"], score_matrix(), "cpu",
                 tile_budget=budget)
    assert db.plan.holds(("tables",)) and db.ring is not None
    for lb, n in zip(lbs, counts):
        assert not db.plan.holds(("tiles", int(lb), engine.A_PAD))
        assert n > 2 * db.slab_rows(int(lb) + engine.A_PAD)
    seen = []

    def spy(qk, db_, pj, pp):
        out = prepass.pairs_min_ed(qk, db_, pj, pp)
        seen.append(engine._stream_stats(qk))
        return out
    a = dict(mode="BEST", prepass=16, rc=True, heur=False)
    ref, got = _both(work, a, db=db, spy=spy)
    assert got == ref == _both(work, a)[1]
    (st,) = seen
    assert st["slabs"] >= 3 * len(lbs) and st["h2d_bytes"] > 0
    assert st["streamed"] == {(int(lb), engine.A_PAD) for lb in lbs}
