"""Port parity for the direct (no-accelerator) path: the port's
`compute_ed_matrix` / `compute_ed_select` equal burst_tpu's arrays on
the workload of tests/test_ed_select.py, and
`burst_tpu_torch.serving.Aligner(rd, None, mode=m, device="cpu")`
emits the same b6 bytes as `burst_tpu.serving.Aligner` in all five
modes, both strands; plus one accelerated BEST batch that holds
full-scan rows. The database is built once by burst_tpu and carried
across by `state.from_reference`. Tolerance 0."""
import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix
from burst_tpu.io.taxonomy import Taxonomy
from burst_tpu.process import process_queries, process_references
from burst_tpu.serving import Aligner as JAligner
from burst_tpu_torch import engine as pengine
from burst_tpu_torch.io.taxonomy import Taxonomy as PTaxonomy
from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
from burst_tpu_torch.serving import MODES, Aligner
from burst_tpu_torch.state import from_reference, load_db

from . import golden

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

TIE_MODES = ["BEST", "ALLPATHS", "CAPITALIST", "FORAGE"]


def _arrays(pairs):
    enc = lambda s: np.frombuffer(s.encode(), np.uint8).copy()
    return [h.encode() for h, _ in pairs], [enc(s) for _, s in pairs]


@pytest.fixture(scope="module")
def workload():
    """tests/test_ed_select.py's workload, with burst_tpu's dense matrix
    (one reference compile for the whole module)."""
    rng = np.random.default_rng(31337)
    refs = golden.make_refs(rng, 60, lo=100, hi=700)
    reads = golden.make_reads(rng, refs, 220, read_len=90, max_err=3,
                              rc_frac=0.4)
    rheads, rseqs = _arrays(refs)
    qheads, qseqs = _arrays(reads)
    rd = process_references(rheads, rseqs, max_len_q=90, thres=0.97,
                            rebase=True, rebase_amt=300, curate=2)
    qd = process_queries(qheads, qseqs, 0.97, True)
    ed = jengine.compute_ed_matrix(qd, rd, score_matrix())
    db = load_db(from_reference(rd)[0], None, score_matrix(), "cpu")
    return qd, rd, ed, db


def test_ed_matrix_matches_jax(workload):
    qd, rd, ed, db = workload
    got = pengine.compute_ed_matrix(qd, db)
    assert got.dtype == np.uint8 and got.shape == ed.shape
    np.testing.assert_array_equal(got, ed)
    assert (ed <= 3).sum() > 200 and len(np.unique(pengine._unit_lb(rd))) > 2


@pytest.mark.parametrize("mode", TIE_MODES)
def test_ed_select_matches_jax(workload, mode):
    qd, rd, ed, db = workload
    ref = jengine.select_pods(qd, rd, ed, mode)
    assert len(ref[0]) > 150
    for got in (pengine.compute_ed_select(qd, db, mode),
                pengine.select_pods(qd, db.rd, ed, mode)):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ed_select_with_forced_compaction(workload):
    """compact_at=16 forces a compaction after nearly every block."""
    qd, rd, ed, db = workload
    ref = jengine.select_pods(qd, rd, ed, "BEST")
    got = pengine.compute_ed_select(qd, db, "BEST", compact_at=16)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_align_pods_match_jax(workload):
    """Phase B on the direct path: every winner at full width, FORAGE
    under the query-budget bound, reference pod order."""
    import dataclasses
    qd, rd, _, db = workload
    for mode in ("BEST", "FORAGE"):
        ref = jengine.align(qd, rd, mode, score_matrix())
        got = pengine.align(qd, db, mode)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(ref, f.name), f.name)


@pytest.fixture(scope="module")
def mixed():
    """Two query buckets -- 90 bp reads (W=3) and two short reads whose 4
    unibin rows (W=2) are fewer than one K4 query group -- against units
    in several length buckets, one of them under one tile group (128
    units); burst_tpu's dense matrix over it."""
    rng = np.random.default_rng(4242)
    refs = golden.make_refs(rng, 40, lo=100, hi=700)
    reads = golden.make_reads(rng, refs, 60, read_len=90, max_err=3,
                              rc_frac=0.4)
    reads += [("short0", refs[3][1][20:60]), ("short1", refs[8][1][5:63])]
    rheads, rseqs = _arrays(refs)
    qheads, qseqs = _arrays(reads)
    rd = process_references(rheads, rseqs, max_len_q=90, thres=0.97,
                            rebase=True, rebase_amt=300, curate=2)
    qd = process_queries(qheads, qseqs, 0.97, True)
    ed = jengine.compute_ed_matrix(qd, rd, score_matrix())
    db = load_db(from_reference(rd)[0], None, score_matrix(), "cpu")
    return qd, rd, ed, db


_PLANS = {
    # the reference's fixed 2048 x 512 blocks (the port's former plan)
    "2048x512": lambda nq, nt, W, sms, cap: (
        min(2048, pengine._pow2_ceil(nq)), min(512, pengine._pow2_ceil(nt))),
    # blocks of 33 rows x 7 units: ragged in both axes, many compactions
    "33x7": lambda nq, nt, W, sms, cap: (33, 7),
}


@pytest.mark.parametrize("mode", ["ANY"] + TIE_MODES)
def test_ed_blocks_any_plan_same_result(mixed, mode, monkeypatch):
    """compute_ed_matrix (ANY) and compute_ed_select (the other four
    modes) give identical results under the plan in use, the former
    2048 x 512 plan and a ragged 33 x 7 one, and equal burst_tpu's."""
    qd, rd, ed, db = mixed
    qw = {len(s) for s in qd.seqs}
    lbs, nlb = np.unique(pengine._unit_lb(rd), return_counts=True)
    assert len({-(-n // 32) for n in qw}) == 2 and len(lbs) >= 2
    assert sum(-(-n // 32) == 2 for n in (len(s) for s in qd.seqs)) == 4
    assert nlb.min() < 128
    if mode == "ANY":
        ref = (ed,)
        run = lambda: (pengine.compute_ed_matrix(qd, db),)
    else:
        ref = jengine.select_pods(qd, rd, ed, mode)
        assert len(ref[0]) > 40
        run = lambda: pengine.compute_ed_select(qd, db, mode,
                                                compact_at=64)
    outs = {"plan": run()}
    for name, plan in _PLANS.items():
        monkeypatch.setattr(pengine, "cross_blocks", plan)
        outs[name] = run()
    for got in outs.values():
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def served():
    """A small database with duplicate and near-duplicate references and
    a taxonomy; reads on both strands, some with an N, some repeated."""
    rng = np.random.default_rng(77)
    refs = golden.make_refs(rng, 30, lo=150, hi=650)
    for i in (3, 11):                 # near-duplicates: ties across refs
        s = list(refs[i][1])
        s[40] = "A" if s[40] != "A" else "C"
        refs.append((f"near{i:02d}", "".join(s)))
    refs.append(("dup05", refs[5][1]))
    reads = golden.make_reads(rng, refs, 90, read_len=100, max_err=3,
                              rc_frac=0.4)
    reads[4] = (reads[4][0], reads[4][1][:30] + "N" + reads[4][1][31:])
    reads.append(("again", reads[0][1]))
    reads.append(("junk", golden.rand_dna(rng, 100)))
    rheads, rseqs = _arrays(refs)
    qheads, qseqs = _arrays(reads)
    rd = process_references(rheads, rseqs, max_len_q=100, thres=0.96,
                            rebase=True, rebase_amt=320, curate=2)
    pairs = [(h, b"k__K;p__P%d;c__C%d;o__O%d;f__F%d" % (
        i % 2, i % 3, i % 5, i)) for i, h in enumerate(sorted(set(rheads)))]
    return rd, pairs, qheads, qseqs


@pytest.mark.parametrize("mode", MODES)
def test_direct_b6_matches_jax(served, mode):
    rd, pairs, qheads, qseqs = served
    kw = dict(thres=0.96, mode=mode, do_rc=True)
    ref = JAligner(rd, None, taxonomy=Taxonomy(pairs), **kw).align_batch(
        qheads, [s.copy() for s in qseqs])
    k3, k4 = rescore_cuda.rescore.launches, myers_cuda.myers_cross.launches
    al = Aligner(from_reference(rd)[0], None, taxonomy=PTaxonomy(pairs),
                 device="cpu", **kw)
    got = al.align_batch(qheads, [s.copy() for s in qseqs])
    assert ref.count(b"\n") >= 85
    assert got == ref
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (rescore_cuda.rescore.launches,
            myers_cuda.myers_cross.launches) == (k3, k4)


def test_direct_capitalist_taxacut_and_best_flags(served):
    rd, pairs, qheads, qseqs = served
    prd = from_reference(rd)[0]
    for kw in (dict(mode="CAPITALIST", taxacut=3),
               dict(mode="BEST", taxasuppress=True, strict=True)):
        kw.update(thres=0.96, do_rc=True)
        ref = JAligner(rd, None, taxonomy=Taxonomy(pairs), **kw
                       ).align_batch(qheads, [s.copy() for s in qseqs])
        got = Aligner(prd, None, taxonomy=PTaxonomy(pairs), device="cpu",
                      **kw).align_batch(qheads, [s.copy() for s in qseqs])
        assert got == ref


def test_from_fasta_matches_jax(tmp_path):
    path = str(tmp_path / "refs.fa")
    golden.write_fasta(path, [
        (f"r{i}", golden.rand_dna(np.random.default_rng(i), 300 + 20 * i))
        for i in range(12)])
    heads, seqs = _arrays(golden.make_reads(
        np.random.default_rng(5), golden.read_fasta(path), 30,
        read_len=80, max_err=2, rc_frac=0.5))
    kw = dict(shear=0, thres=0.95, mode="ALLPATHS", do_rc=True)
    ref = JAligner.from_fasta(path, **kw).align_batch(
        heads, [s.copy() for s in seqs])
    got = Aligner.from_fasta(path, device="cpu", **kw).align_batch(
        heads, [s.copy() for s in seqs])
    assert ref.count(b"\n") >= 28 and got == ref


def test_accel_best_with_full_scan_rows_matches_jax(monkeypatch):
    """Accelerated BEST where some reads are under k (full-scan rows go
    through the dense cross scan instead of raising)."""
    from burst_tpu.kernels import scour_device as jsd

    rng = np.random.default_rng(9)
    refs = golden.make_refs(rng, 30, lo=500, hi=700)
    reads = golden.make_reads(rng, refs, 80, read_len=100, max_err=2,
                              rc_frac=0.3)
    reads[3] = ("short3", refs[2][1][100:110])         # 10 bp < k
    reads[40] = ("short40", refs[7][1][50:61])
    reads[41] = ("n41", reads[41][1][:20] + "N" + reads[41][1][21:])
    rheads, rseqs = _arrays(refs)
    qheads, qseqs = _arrays(reads)
    rd = process_references(rheads, rseqs, max_len_q=100, thres=0.98,
                            rebase=True, rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    kw = dict(thres=0.98, mode="BEST", do_rc=True)
    ref = JAligner(rd, acc, **kw).align_batch(
        qheads, [s.copy() for s in qseqs])
    al = Aligner(*from_reference(rd, acc), device="cpu", **kw)
    got = al.align_batch(qheads, [s.copy() for s in qseqs])
    assert al.last_stats["full_rows"] == 4
    assert b"short3\t" in ref and b"short40\t" in ref
    assert got == ref
