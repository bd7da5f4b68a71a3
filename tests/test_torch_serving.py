"""The rest of the serving API and the native-scour route, held to
burst_tpu's bytes: burst_tpu_torch on the CPU (plain kernel versions)
against burst_tpu on jax-CPU with its device scour on
(BURST_TPU_DEV_SCOUR=1), exact byte equality.

  (a) unit postings that are not clump-grouped (one word's postings
      permuted in the unit index both packages share): `state.load_db`
      serves them, the plan routes the scour to the native host scour
      (its slow walk), no fused scan runs, and the bytes equal
      burst_tpu's in BEST (the fused request, and the two-step path at
      the batch's QBUNCH) and in CAPITALIST;
  (b) `Aligner.align_batch(..., dev_scour=False)`: the native scour for
      that batch, burst_tpu's bytes and the port's default bytes;
  (c) `Aligner.align_stream(batches, alternate=True)`: every other batch
      through the native scour, burst_tpu's bytes in order."""
import io

import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix as jscore_matrix
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.process import bin_queries_for_accel as jbin
from burst_tpu.process import process_queries as jprocess_queries
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner as JAligner

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
THRES = 0.98


@pytest.fixture(autouse=True)
def _device_scour(monkeypatch):
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    # slot budgets that no row of this workload overflows, small chunks
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "1024")
    monkeypatch.setenv("BURST_TPU_SCOUR_EB", "8192")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    monkeypatch.setenv("BURST_TPU_SCOUR_BCHUNK", "64")
    monkeypatch.setattr(jsd, "CHUNK_BUNCH", 64)


def _workload(seed):
    """Ten families of three 600 bp members at 1 % from their ancestor;
    300 reads of 100 bp with up to two substitutions, every 37th with an
    N, every 61st cut to 9 bp (a full-scan row)."""
    rng = np.random.default_rng(seed)
    refs, rheads = [], []
    for f in range(10):
        anc = rng.choice(BASES, size=600)
        for m in range(3):
            r = anc.copy()
            pos = rng.integers(0, 600, 6)
            r[pos] = BASES[rng.integers(0, 4, 6)]
            refs.append(r)
            rheads.append(b"f%03dm%02d" % (f, m))
    heads, reads = [], []
    for i in range(300):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, 500))
        r = s[st:st + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 100))] = BASES[int(rng.integers(0, 4))]
        if i % 37 == 0:
            r[int(rng.integers(0, 100))] = ord("N")
        if i % 61 == 3:
            r = r[:9].copy()
        reads.append(r)
        heads.append(b"q%04d" % i)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=100, thres=THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    jengine.rd_acc_unit_index(rd, acc)
    return rd, acc, heads, reads


def _aligners(rd, acc, mode):
    from burst_tpu_torch.serving import Aligner
    from burst_tpu_torch.state import from_reference
    kw = dict(thres=THRES, mode=mode, do_rc=True)
    return JAligner(rd, acc, **kw), Aligner(*from_reference(rd, acc),
                                            device="cpu", **kw)


@pytest.fixture(scope="module")
def grouped():
    return _workload(41)


@pytest.fixture(scope="module")
def permuted():
    """The same kind of database with one word's unit postings
    reversed in the index both packages share: not clump-grouped."""
    from burst_tpu.native import _unit_ids_clump_grouped
    rd, acc, heads, reads = _workload(43)
    u = acc.u_csr
    w = int(np.nonzero((u.cnt >= 2) & (u.cnt <= 16))[0][0])
    s0, n = int(u.start[w]), int(u.cnt[w])
    assert len(np.unique(u.ids[s0:s0 + n])) == n
    u.ids[s0:s0 + n] = u.ids[s0:s0 + n][::-1].copy()
    u.__dict__.pop("_clump_grouped", None)
    assert not _unit_ids_clump_grouped(u, 16)
    return rd, acc, heads, reads


def _jax_two_step_best(rd, acc, heads, reads):
    """burst_tpu's two-step BEST at the batch's default QBUNCH (its
    CLI's flow at -t 1)."""
    from burst_tpu import modes as jmodes
    sm = jscore_matrix()
    qd = jprocess_queries(heads, [r.copy() for r in reads], THRES, True)
    visits = jengine.accel_candidates(qd, rd, acc, jbin(qd, acc.k, 1))
    ed = jengine.compute_ed_matrix_accel(qd, rd, visits, sm)
    juni, refpos, eds = jengine.select_pods(qd, rd, ed, "BEST")
    order = jengine.accel_pod_order(qd, rd, visits, juni, refpos, eds)
    pods = jengine.rescore_winners(
        qd, rd, juni, refpos, eds, "BEST", sm, order,
        win_cols=ed.lookup_cols(juni, refpos, rd.tot_units))
    buf = io.StringIO()
    jmodes.report_best(pods, qd, rd, jmodes.B6Writer(buf))
    return buf.getvalue().encode("latin-1"), visits.qbunch


@pytest.mark.parametrize("mode", ["BEST", "CAPITALIST"])
def test_permuted_postings_take_the_native_scour(permuted, mode):
    rd, acc, heads, reads = permuted
    jal, al = _aligners(rd, acc, mode)
    ref = jal.align_batch(heads, [r.copy() for r in reads])
    got = al.align_batch(heads, [r.copy() for r in reads])
    assert got == ref and ref.count(b"\n") > 250
    plan = al.db.plan
    assert plan.scour == "native" and "clump-grouped" in plan.why
    assert al.db.tabs is None
    st = al.last_stats
    # BEST asked for the fused scan and went down the two-step path
    assert st["scour"] == "native" and "dev_pairs" not in st
    assert (st["qbunch"] == 1) == (mode == "BEST")


def test_permuted_postings_two_step_best(permuted):
    """BEST on the two-step path at the batch's QBUNCH (above 1), as the
    CLI runs it at -t 1."""
    from burst_tpu_torch import engine, modes
    from burst_tpu_torch.process import process_queries
    from burst_tpu_torch.serving import align_queries
    rd, acc, heads, reads = permuted
    ref, qbunch = _jax_two_step_best(rd, acc, heads, reads)
    al = _aligners(rd, acc, "BEST")[1]
    qd = process_queries(heads, [r.copy() for r in reads], THRES, True)
    buf = io.StringIO()
    path, st = align_queries(qd, al.db, "BEST", modes.B6Writer(buf),
                             qbunch=engine.default_qbunch(len(qd.seqs), 1),
                             fuse=True)
    assert path == "two-step" and st["qbunch"] == qbunch > 1
    assert st["scour"] == "native"
    assert buf.getvalue().encode("latin-1") == ref


@pytest.mark.parametrize("mode", ["BEST", "CAPITALIST"])
def test_align_batch_dev_scour_false(grouped, mode):
    rd, acc, heads, reads = grouped
    jal, al = _aligners(rd, acc, mode)
    ref = jal.align_batch(heads, [r.copy() for r in reads],
                          dev_scour=False)
    got = al.align_batch(heads, [r.copy() for r in reads],
                         dev_scour=False)
    st = al.last_stats
    assert got == ref and ref.count(b"\n") > 250
    assert st["scour"] == "native" and "dev_pairs" not in st
    assert al.db.plan.scour == "device"
    default = al.align_batch(heads, [r.copy() for r in reads])
    assert default == got and "scour" not in al.last_stats
    if mode == "BEST":
        assert al.last_stats["dev_pairs"] > 0       # the fused scan


def test_align_stream_alternate(grouped):
    rd, acc, heads, reads = grouped
    jal, al = _aligners(rd, acc, "BEST")
    batches = [(heads[i:i + 100], reads[i:i + 100])
               for i in range(0, 300, 100)]

    def copies():
        return [(h, [r.copy() for r in s]) for h, s in batches]
    ref = list(jal.align_stream(copies(), alternate=True))
    # one batch in flight at a time: each batch's stats right after it
    seen = []
    align = al.align_batch

    def recording(*a, **kw):
        out = align(*a, **kw)
        seen.append(dict(al.last_stats))
        return out
    al.align_batch = recording
    got = list(al.align_stream(copies(), depth=1, alternate=True))
    del al.align_batch
    assert got == ref and all(b.count(b"\n") > 80 for b in got)
    assert [s.get("scour") for s in seen] == [None, "native", None]
    assert [("dev_pairs" in s) for s in seen] == [True, False, True]
    assert got == [al.align_batch(h, s) for h, s in copies()]
