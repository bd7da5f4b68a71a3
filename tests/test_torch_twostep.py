"""Port parity for the two-step accelerated path: burst_tpu_torch on the
CPU (plain kernel versions) against burst_tpu on jax-CPU with its device
scour on (BURST_TPU_DEV_SCOUR=1), exact equality throughout (all integer
arithmetic; b6 compared as bytes):

  (a) the device scour's result dicts (`scour_rows`, `scour_bunch_rows`)
      at k=12 (dense rank table) and k=15 (binary search);
  (b) every field of `Visits` from `accel_candidates` at QBUNCH 1, 2, 5,
      16 and the batch's default, with N reads so that the ambiguous
      prefix straddles a bunch;
  (c) bunch-row and member-row overflow forced by small slot budgets, the
      budgets the port derives from the database, and the winner-buffer
      redo;
  (d) a seeded fuzz over QBUNCH 2..16;
  (e) `expand_visit_pairs` and the materialized `SparseED`;
  (f) `Aligner.align_batch` bytes for ALLPATHS, FORAGE, CAPITALIST (with
      a taxonomy and `taxacut`) and ANY, both strands, at a default
      QBUNCH above 1, with N reads and reads shorter than k;
  (g) BEST with an accelerator on batches without a clear row.

One database and one read set serve most cases: every new shape is one
more XLA compile on the reference side. The bunch chunk is cut to 64 rows
in both packages for the same reason (the reference's slot-owner loop
runs one step per bunch word over the whole chunk)."""
import dataclasses

import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix
from burst_tpu.io.taxonomy import Taxonomy as JTaxonomy
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.process import bin_queries_for_accel as jbin
from burst_tpu.process import process_queries as jprocess_queries
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner as JAligner
from burst_tpu_torch import engine, modes
from burst_tpu_torch.io.taxonomy import Taxonomy
from burst_tpu_torch.kernels import scour_device as psd
from burst_tpu_torch.process import bin_queries_for_accel, process_queries
from burst_tpu_torch.serving import Aligner
from burst_tpu_torch.state import from_reference, load_db

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

CPU = torch.device("cpu")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
VISIT_FIELDS = ("flat", "offs", "full", "pass_keys", "filtered",
                "bad_clump", "bflat", "boffs", "qbunch", "bad_list")


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    # slot budgets that no row of these workloads overflows
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "1024")
    monkeypatch.setenv("BURST_TPU_SCOUR_EB", "8192")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    monkeypatch.setenv("BURST_TPU_SCOUR_BCHUNK", "64")
    monkeypatch.setattr(jsd, "CHUNK_BUNCH", 64)


def _reads(rng, refs, n_reads, n_every=0, short_every=0, read_len=100):
    reads, heads = [], []
    for i in range(n_reads):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, len(s) - read_len))
        r = s[st:st + read_len].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, read_len))] = BASES[int(rng.integers(0, 4))]
        if i % 53 == 7:
            # a tandem repeat: its k-mers come four times each (the MAX
            # multiplicity weights of a bunch)
            r = np.tile(r[:read_len // 4], 4)
        if n_every and i % n_every == 0:
            r[int(rng.integers(0, read_len))] = ord("N")
        if short_every and i % short_every == 3:
            r = r[:9].copy()              # under k: a full-scan row
        reads.append(r)
        heads.append(b"q%05d" % i)
    return heads, reads


class _Work:
    """One database and one read batch in both packages."""

    def __init__(self, seed, k=12, n_fam=10, n_mem=3, ref_len=600,
                 n_reads=330, n_every=37, short_every=0, do_rc=False,
                 thres=0.98):
        rng = np.random.default_rng(seed)
        refs, self.rheads = [], []
        for f in range(n_fam):
            anc = rng.choice(BASES, size=ref_len)
            for m in range(n_mem):
                r = anc.copy()
                pos = rng.integers(0, ref_len, ref_len // 100)
                r[pos] = BASES[rng.integers(0, 4, len(pos))]
                refs.append(r)
                self.rheads.append(b"f%03dm%02d" % (f, m))
        self.heads, self.reads = _reads(rng, refs, n_reads, n_every,
                                        short_every)
        self.thres, self.do_rc, self.k = thres, do_rc, k
        self.rd = process_references(
            self.rheads, [r.copy() for r in refs], max_len_q=100,
            thres=thres, rebase=True, rebase_amt=320, curate=2)
        self.acc = build_accelerator(self.rd, k=k, z=1)
        jengine.rd_acc_unit_index(self.rd, self.acc)
        self.prd, self.pacc = from_reference(self.rd, self.acc)
        self.db = load_db(self.prd, self.pacc, score_matrix(), CPU)
        self.n_clumps = -(-self.rd.tot_units // 16)

    def batch(self, heads=None, reads=None):
        """(reference qd and bins, port qd and bins) of one batch."""
        heads = self.heads if heads is None else heads
        reads = self.reads if reads is None else reads
        jqd = jprocess_queries(heads, [r.copy() for r in reads],
                               self.thres, self.do_rc)
        pqd = process_queries(heads, [r.copy() for r in reads],
                              self.thres, self.do_rc)
        return (jqd, jbin(jqd, self.k, 1),
                pqd, bin_queries_for_accel(pqd, self.k, 1))


@pytest.fixture(scope="module")
def work():
    return _Work(7)


@pytest.fixture(scope="module")
def work15():
    return _Work(13, k=15, n_reads=150)


def _same_visits(got, ref):
    for name in VISIT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
    assert {f.name for f in dataclasses.fields(ref)} == set(VISIT_FIELDS)


def _visits(w, qbunch, batch=None):
    jqd, jbins, pqd, pbins = batch or w.batch()
    ref = jengine.accel_candidates(jqd, w.rd, w.acc, jbins, qbunch=qbunch)
    got = engine.accel_candidates(pqd, w.db, pbins, qbunch=qbunch)
    _same_visits(got, ref)
    return got, ref, (jqd, pqd)


# ------------------------------------------------- (a) the scour's dicts

def _same_dict(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("wname", ["work", "work15"])
def test_scour_rows_matches_jax(wname, request):
    w = request.getfixturevalue(wname)
    jqd, jbins, _, _ = w.batch()
    b0, b1 = int(jbins[0]), int(jbins[1])
    qmat, qlens, _ = jengine._query_matrix(jqd)
    mm_m, mm_i, _ = jengine.bunch_thresholds(jqd, b1, w.k, 1, False)
    args = (qmat[b0:b1], qlens[b0:b1], w.k, mm_m[b0:b1], mm_i[b0:b1])
    ref = jsd.scour_rows(*args, jsd.get_tables(w.acc), w.n_clumps,
                         w.rd.tot_units)
    got = psd.scour_rows(*args, w.db.tabs, w.rd.tot_units)()
    _same_dict(got, ref)
    assert len(got["cj"]) > 100 and len(got["ukeys"]) > 100
    # the clump filter saturated, as the bunch path's member dispatch
    sat = np.full(b1 - b0, 1 << 60, np.int64)
    ref = jsd.scour_rows(*args[:3], sat, args[4], jsd.get_tables(w.acc),
                         w.n_clumps, w.rd.tot_units)
    got = psd.scour_rows(*args[:3], sat, args[4], w.db.tabs,
                         w.rd.tot_units)()
    _same_dict(got, ref)
    assert len(got["cj"]) == 0 and len(got["ukeys"]) > 100


@pytest.mark.parametrize("wname,qbunch", [("work", 4), ("work15", 3)])
def test_scour_bunch_rows_matches_jax(wname, qbunch, request):
    w = request.getfixturevalue(wname)
    jqd, jbins, pqd, _ = w.batch()
    b0, b1 = int(jbins[0]), int(jbins[1])
    g0 = -(-b0 // qbunch)
    mm_b, _, _ = jengine.bunch_thresholds(jqd, b1, w.k, qbunch, False)
    ref_w = jengine._bunch_words_padded(jqd, g0 * qbunch, b1, qbunch, w.k)
    got_w = engine._bunch_words_padded(pqd, g0 * qbunch, b1, qbunch, w.k)
    for a, b in zip(got_w, ref_w):
        np.testing.assert_array_equal(a, b)
    wmat, wgt, nwords = ref_w
    assert wgt.max() >= 4                 # the tandem-repeat reads
    # unit winners on as well (weighted unit hits) with a low bar, in
    # every 8th row: more would overflow the reference's winner buffers
    mm_u = np.full(len(nwords), 1 << 60, np.int64)
    mm_u[::8] = 20
    ref = jsd.scour_bunch_rows(wmat, wgt, nwords, mm_b[g0:], mm_u,
                               jsd.get_tables(w.acc), w.rd.tot_units)
    got = psd.scour_bunch_rows(wmat, wgt, nwords, mm_b[g0:], mm_u,
                               w.db.tabs, w.rd.tot_units)()
    _same_dict(got, ref)
    assert len(got["cj"]) > 50 and len(got["ukeys"]) > 20


def test_bunch_weights_clip_like_the_native_walk():
    """Hit counts add the per-word weight and saturate at 0xFFFF, as the
    native walk does; the weighted unit count does not."""
    tabs = psd.ScourTables.__new__(psd.ScourTables)
    n_words = 3
    tabs.rank = torch.arange(1 << 4)          # word w -> rank w (k = 2)
    tabs.nzw = None
    # words 1..3 each post units 0 and 17 (clumps 0 and 1)
    tabs.start = torch.tensor([0, 0, 2, 4] + [0] * 12)
    tabs.cnt = torch.tensor([0, 2, 2, 2] + [0] * 12)
    tabs.ids = torch.tensor([0, 17] * n_words, dtype=torch.int32)
    wmat = torch.tensor([[1, 2, 3]])
    wgt = torch.tensor([[40000, 30000, 5]])
    ov, ccount, cj, ccl, chits, cminw, ucount, uj, uu = \
        psd._scour_core_words(wmat, torch.tensor([3]), wgt, tabs,
                              torch.tensor([0]), torch.tensor([70000]),
                              8, 4, 4)
    assert not bool(ov[0]) and int(ccount) == 2 and int(ucount) == 2
    assert ccl[:2].tolist() == [0, 1] and chits[:2].tolist() == [0xFFFF] * 2
    assert cminw[:2].tolist() == [1, 1] and uu[:2].tolist() == [0, 17]


# ------------------------------------- (b) Visits at every bunch width

@pytest.mark.parametrize("qbunch", [1, 2, 5, 16, None])
def test_visits_match_jax(work, qbunch):
    got, _, (jqd, _) = _visits(work, qbunch)
    b0 = int(jbin(jqd, work.k, 1)[0])
    assert b0 == 9                       # the prefix straddles a bunch
    want = qbunch or jengine.default_qbunch(len(jqd.seqs), 1)
    assert got.qbunch == want and (qbunch is not None or want == 2)
    assert got.offs[-1] > 0 and len(got.pass_keys) > 300
    assert got.stats == {"bunch_ov_rows": 0, "member_ov_rows": 0}


def test_visits_match_jax_k15(work15):
    got, _, _ = _visits(work15, 4)
    assert got.offs[-1] > 0


def test_visits_without_a_clear_bunch(work):
    """Every bunch holds an ambiguous row, or no row has a word: the host
    prefix scour is the whole scour; the lists still match."""
    reads = [r.copy() for r in work.reads[:40]]
    for r in reads:
        r[50] = ord("N")
    _visits(work, 4, work.batch(work.heads[:40], reads))
    short = [r[:9].copy() for r in work.reads[:6]]
    got, _, _ = _visits(work, 2, work.batch(work.heads[:6], short))
    assert got.full.all() and got.bflat is None


# --------------------------------------------------------- (c) overflow

@pytest.mark.parametrize("env,val,stat", [
    ("BURST_TPU_SCOUR_EB", "64", "bunch_ov_rows"),
    ("BURST_TPU_SCOUR_E", "48", "member_ov_rows"),
])
def test_visits_overflow_spliced(work, env, val, stat, monkeypatch):
    monkeypatch.setenv(env, val)
    got, _, _ = _visits(work, 8)
    assert got.stats[stat] > 0
    if env.endswith("_E"):
        # partial overflow at QBUNCH=1 as well
        monkeypatch.setenv(env, "96")
        got, _, _ = _visits(work, 1)
        assert 0 < got.stats["member_ov_rows"] < len(got.full)


def test_slot_budgets_follow_the_database(work, monkeypatch):
    """Without the knobs the budgets come from the postings' own depth
    and the chunks from the budgets; the knobs still override them, and
    the lists are the reference's either way."""
    for name in ("E", "EB", "CHUNK", "BCHUNK"):
        monkeypatch.delenv("BURST_TPU_SCOUR_" + name)
    tabs = work.db.tabs
    cnt = work.pacc.u_csr.cnt.astype(np.float64)
    assert tabs.depth == pytest.approx((cnt ** 2).sum() / cnt.sum())
    E = psd.slot_budget(tabs, 89)
    assert E == max(256, -(-int(np.ceil(1.5 * 89 * tabs.depth)) // 256) * 256)
    EB = psd.bunch_slot_budget(tabs, 8 * 89)
    assert EB == max(
        4096, -(-int(np.ceil(1.25 * 8 * 89 * tabs.depth)) // 256) * 256)
    assert psd.chunk_rows(E) == min(4096, psd.SLOT_TARGET // E)
    assert psd.chunk_rows(1 << 20) == psd.bunch_chunk_rows(1 << 20) == 12
    assert psd.bunch_chunk_rows(4096) == 512
    got, _, _ = _visits(work, 8)
    n = len(got.full)
    assert got.stats["bunch_ov_rows"] == 0
    assert got.stats["member_ov_rows"] <= n // 50
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "48")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "16")
    assert psd.slot_budget(tabs, 89) == 48 and psd.chunk_rows(48) == 16


def test_winner_buffers_grow_and_stick(work, monkeypatch):
    """Chunks of 16 rows hold 32 winners at factor 2: the bunch rows win
    more clumps and the member rows more units than that, so both redo
    once with bigger buffers, and the tables remember."""
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "16")
    monkeypatch.setenv("BURST_TPU_SCOUR_BCHUNK", "16")
    jqd, jbins, pqd, pbins = work.batch()
    ref = jengine.accel_candidates(jqd, work.rd, work.acc, jbins, qbunch=8)
    tabs = work.db.tabs
    saved = tabs.cap_factor, tabs.cap_factor_bunch
    tabs.cap_factor = tabs.cap_factor_bunch = 2
    try:
        got = engine.accel_candidates(pqd, work.db, pbins, qbunch=8)
        grown = tabs.cap_factor, tabs.cap_factor_bunch
        again = engine.accel_candidates(pqd, work.db, pbins, qbunch=8)
        assert (tabs.cap_factor, tabs.cap_factor_bunch) == grown
    finally:
        tabs.cap_factor, tabs.cap_factor_bunch = saved
    assert grown[0] >= 4 and grown[1] >= 4
    _same_visits(got, ref)
    _same_visits(again, ref)


# ------------------------------------------------------------- (d) fuzz

@pytest.mark.parametrize("seed", [404, pytest.param(
    505, marks=pytest.mark.slow), pytest.param(606, marks=pytest.mark.slow)])
def test_visits_qbunch_fuzz(seed):
    rng = np.random.default_rng(seed)
    qbunch = int(rng.integers(2, 17))
    w = _Work(seed, n_fam=int(rng.integers(4, 16)),
              n_mem=int(rng.integers(1, 5)),
              ref_len=int(rng.integers(400, 1200)),
              n_reads=int(rng.integers(100, 500)),
              n_every=int(rng.integers(0, 2)) * 23,
              do_rc=bool(rng.integers(0, 2)))
    got, _, _ = _visits(w, qbunch)
    assert got.offs[-1] > 0


# ---------------------------------------- (e) expanded pairs, SparseED

@pytest.mark.parametrize("qbunch", [1, 2, 5, 16])
def test_pairs_and_sparse_ed_match_jax(qbunch):
    w = _Work(29, n_reads=150, n_every=17, short_every=50)
    got_v, ref_v, (jqd, pqd) = _visits(w, qbunch)
    rj, rp = jengine.expand_visit_pairs(jqd, w.rd, ref_v)
    gj, gp = engine.expand_visit_pairs(pqd, w.prd, got_v)
    np.testing.assert_array_equal(gj, rj)
    np.testing.assert_array_equal(gp, rp)
    ref = jengine.compute_ed_matrix_accel(jqd, w.rd, ref_v, score_matrix())
    got = engine.compute_ed_matrix_accel(pqd, w.db, got_v)
    assert got.pe is None and got.pending       # deferred until asked
    got.materialize()
    assert len(got.pj) > 400 and len(got.full_rows) == 3
    for name in ("pj", "pp", "pe", "pfirst", "plast", "full_rows",
                 "ed_full"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    nj = len(pqd.seqs)
    np.testing.assert_array_equal(
        engine.densify(got, nj, w.rd.tot_units),
        jengine.densify(ref, nj, w.rd.tot_units))
    juni, refpos = got.pj[::7], got.pp[::7]
    np.testing.assert_array_equal(
        got.lookup_last(juni, refpos, w.rd.tot_units),
        ref.lookup_last(juni, refpos, w.rd.tot_units))


# ------------------------------------------------- (f), (g) b6 bytes

@pytest.fixture(scope="module")
def served():
    """A database of 97 %-ish families and 330 reads, both strands (660
    unibins: default QBUNCH 5), every 29th read with an N, every 41st
    under k; and a taxonomy over the references."""
    w = _Work(53, n_fam=8, n_mem=4, n_reads=330, n_every=29,
              short_every=41, do_rc=True, thres=0.97)
    tax = [(h, b"k__K;p__P%d;c__C%d;o__O%d" % (
        int(h[1:4]) % 3, int(h[1:4]), int(h[5:7]))) for h in w.rheads]
    return w, JTaxonomy(tax), Taxonomy(tax)


def _both(w, mode, heads, reads, **kw):
    jkw = dict(kw)
    pkw = dict(kw)
    if "taxonomy" in kw:
        jkw["taxonomy"], pkw["taxonomy"] = kw["taxonomy"]
    ref = JAligner(w.rd, w.acc, thres=w.thres, mode=mode, do_rc=w.do_rc,
                   **jkw).align_batch(heads, [r.copy() for r in reads])
    al = Aligner(w.prd, w.pacc, thres=w.thres, mode=mode, do_rc=w.do_rc,
                 device="cpu", **pkw)
    got = al.align_batch(heads, [r.copy() for r in reads])
    assert got == ref
    return got, al


@pytest.mark.parametrize("mode", ["ALLPATHS", "FORAGE", "CAPITALIST", "ANY"])
def test_accel_modes_b6_match_jax(served, mode):
    w, jtax, ptax = served
    kw = {}
    if mode == "CAPITALIST":
        kw = dict(taxonomy=(jtax, ptax), taxacut=5)
    got, al = _both(w, mode, w.heads, w.reads, **kw)
    assert got.count(b"\n") > 250
    st = al.last_stats
    assert st["qbunch"] == 5 and st["pairs"] > 1000
    assert st["full_rows"] == 16


def test_report_any_accel_matches_jax(served):
    """ANY's inline-order report alone, on the visits and sparse EDs of
    both packages at QBUNCH 16."""
    import io

    from burst_tpu import modes as jmodes
    w = served[0]
    got_v, ref_v, (jqd, pqd) = _visits(w, 16)
    ref_ed = jengine.compute_ed_matrix_accel(jqd, w.rd, ref_v,
                                             score_matrix())
    got_ed = engine.compute_ed_matrix_accel(pqd, w.db, got_v)
    rbuf, gbuf = io.StringIO(), io.StringIO()
    jmodes.report_any_accel(ref_ed, ref_v, jqd, w.rd, jmodes.B6Writer(rbuf),
                            score_matrix())
    modes.report_any_accel(got_ed, got_v, pqd, w.db, modes.B6Writer(gbuf))
    assert gbuf.getvalue() == rbuf.getvalue()
    assert gbuf.getvalue().count("\n") > 250


@pytest.mark.parametrize("mode", ["BEST", "CAPITALIST"])
def test_batch_without_clear_rows_matches_jax(served, mode):
    """Only N reads and reads under k: nothing for the fused scan, so
    BEST too takes the two-step path (at QBUNCH=1)."""
    w = served[0]
    reads = [r.copy() for r in w.reads[:24]]
    for i, r in enumerate(reads):
        if len(r) > 20:
            r[10 + i] = ord("N")
    got, al = _both(w, mode, w.heads[:24], reads)
    assert got.count(b"\n") >= 20
    assert al.last_stats["qbunch"] == 1 and al.last_stats["full_rows"] > 0
    # nothing but reads under k: every row is a full-scan row
    got, al = _both(w, mode, w.heads[:3], [r[:9] for r in w.reads[:3]])
    assert al.last_stats["pairs"] == 0 and al.last_stats["full_rows"] > 0


# ------------------------------------------------- what still raises

def test_outside_the_slice_raises(work):
    """What the slice takes in does not raise: a read over 512 bp (17
    Myers words) on the fused path gives burst_tpu's visits and pair
    results; the heuristic cut's visits (the native scour at clump
    level, no unit prefilter) equal burst_tpu's at QBUNCH 1 and 4, and a
    raw-byte database has nothing to fuse (None: the two-step path's
    full scan). A batch whose alphabet is not its database's raises
    ValueError."""
    long_read = np.tile(work.reads[0], 6)[:530]
    jqd, jbins, pqd, pbins = work.batch(work.heads[:8],
                                        work.reads[:7] + [long_read])
    jvis, jsed = jengine.accel_scan_fused(jqd, work.rd, work.acc, jbins,
                                          qbunch=1)
    vis, sed, stats = engine.accel_scan_fused(pqd, work.db, pbins,
                                              qbunch=1)
    _same_visits(vis, jvis)
    jsed.materialize()
    sed.materialize()
    assert stats["dev_pairs"] > 0 and len(sed.pj) == len(jsed.pj)
    for name in ("pj", "pp", "pe", "pfirst", "plast"):
        np.testing.assert_array_equal(getattr(sed, name),
                                      getattr(jsed, name), err_msg=name)
    heads, reads = work.heads[:120], work.reads[:120]
    for qbunch in (1, 4):
        jqd = jprocess_queries(heads, [r.copy() for r in reads],
                               work.thres, work.do_rc)
        pqd = process_queries(heads, [r.copy() for r in reads],
                              work.thres, work.do_rc)
        ref = jengine.accel_candidates(jqd, work.rd, work.acc,
                                       jbin(jqd, work.k, 1, True), True,
                                       qbunch=qbunch)
        got = engine.accel_candidates(
            pqd, work.db, bin_queries_for_accel(pqd, work.k, 1, True),
            True, qbunch=qbunch)
        _same_visits(got, ref)
        assert got.pass_keys is None and len(got.flat) > 100
    xdb = load_db(work.prd, work.pacc, score_matrix(), CPU, xalpha=True)
    with pytest.raises(ValueError, match="raw bytes expected"):
        engine.accel_scan_fused(pqd, xdb, pbins, qbunch=1)
    pqd.xalpha = True
    assert engine.accel_scan_fused(pqd, xdb, pbins, qbunch=1) is None
    for call in (lambda: engine.accel_scan_fused(pqd, work.db, pbins, 1),
                 lambda: engine.accel_candidates(pqd, work.db, pbins),
                 lambda: engine.compute_ed_matrix(pqd, work.db)):
        with pytest.raises(ValueError, match="codes expected"):
            call()


def test_amplicon_shape_b6_matches_jax(monkeypatch):
    """The amplicon workload's shapes at a small scale: families of 12
    members x 1,450 bp at 1.5 % from their ancestor, 292 bp reads with
    0-5 substitutions at -i 0.97 (W = 10, units up to 621 bp: the
    rescore's 384-column window and its widest full width, 1024),
    CAPITALIST with an LCA taxonomy, both strands, default QBUNCH 2. A
    read's words post some 3,000-5,000 units here: some member rows
    overflow 4,096 slots and some bunch rows 8,192, and are spliced from
    the host among rows that the device kept."""
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "4096")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "256")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 256)
    rng = np.random.default_rng(20260821)
    refs, rheads, tax = [], [], []
    for f in range(2):
        anc = rng.choice(BASES, size=1450)
        for m in range(12):
            r = anc.copy()
            pos = rng.integers(0, 1450, 21)
            r[pos] = BASES[rng.integers(0, 4, 21)]
            refs.append(r)
            rheads.append(b"a%dm%02d" % (f, m))
            tax.append(b"k__B;p__P%d;g__G%d;s__S%d_%d" % (f, f, f, m % 3))
    reads, heads = [], []
    for i in range(130):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, 1450 - 292))
        r = s[st:st + 292].copy()
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, 292))] = BASES[int(rng.integers(0, 4))]
        if i % 43 == 1:
            r[100] = ord("N")
        reads.append(r)
        heads.append(b"aq%03d" % i)
    rd = process_references(rheads, [r.copy() for r in refs], max_len_q=292,
                            thres=0.97, rebase=True, rebase_amt=320,
                            curate=2)
    assert int(engine._unit_lb(rd).max()) == 640
    acc = build_accelerator(rd, k=12, z=1)
    pairs = list(zip(rheads, tax))
    ref = JAligner(rd, acc, thres=0.97, mode="CAPITALIST", do_rc=True,
                   taxonomy=JTaxonomy(pairs)
                   ).align_batch(heads, [r.copy() for r in reads])
    al = Aligner(*from_reference(rd, acc), thres=0.97, mode="CAPITALIST",
                 do_rc=True, taxonomy=Taxonomy(pairs), device="cpu")
    got = al.align_batch(heads, [r.copy() for r in reads])
    assert got == ref and got.count(b"\n") == 130
    st = al.last_stats
    assert st["qbunch"] == 2 and st["pairs"] > 1500, st
    assert 0 < st["bunch_ov_rows"] < 65 and 0 < st["member_ov_rows"] < 130
