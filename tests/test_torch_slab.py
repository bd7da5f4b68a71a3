"""Databases larger than the card: the port's residency plan and its
streamed routes on the CPU (plain kernel versions; the "upload" is a
slice of host memory, every other step the card's), held against the
port's resident run and against burst_tpu on jax-CPU with its device
scour on (BURST_TPU_DEV_SCOUR=1). All comparisons are exact b6 bytes.

  (1) the plan under several budgets: its device bytes never pass the
      budget, the pieces give way in the documented order, a budget
      under the least the database needs raises ValueError;
  (2) accelerated, with the tables resident and every tile piece
      streamed: BEST with the packed store planned out (the fused scan
      gives way to the two-step path at QBUNCH=1), ALLPATHS, CAPITALIST
      with a taxonomy, and ANY with its winner tiles cut into pieces;
  (3) direct, every bucket streamed in K4 blocks: BEST and ANY;
  (4) two budgets, the same bytes (the slab rotation);
  (5) the native-scour route, forced by a budget under the tables;
  (6) `align_stream(depth=2)` under a forced budget;
  (7) burst_tpu's own slab path (BURST_TPU_TILE_HBM_MB, in a
      subprocess: jaxlib's CPU compiler faults once compiles pile up in
      one process) against the port's streamed BEST.

Budgets are forced through `tile_budget` so that every streamed bucket
runs in at least 3 slabs, blocks or winner pieces, and each case asserts
so from `last_stats` and the plan."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu.accel import build_accelerator
from burst_tpu.io.taxonomy import Taxonomy as JTaxonomy
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner as JAligner
from burst_tpu_torch import engine, state
from burst_tpu_torch.alphabet import score_matrix
from burst_tpu_torch.io.taxonomy import Taxonomy
from burst_tpu_torch.serving import Aligner
from burst_tpu_torch.state import from_reference, load_db

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
THRES = 0.98
N_READS = 160


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "1024")
    monkeypatch.setenv("BURST_TPU_SCOUR_EB", "8192")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    monkeypatch.setenv("BURST_TPU_SCOUR_BCHUNK", "64")
    monkeypatch.setattr(jsd, "CHUNK_BUNCH", 64)
    monkeypatch.delenv("BURST_TPU_TILE_HBM_MB", raising=False)


class _Work:
    """1,593 units of 160 families x 5 members x 600 bp (length buckets
    320 and 448, 793 and 800 units), 160 reads of 100 bp with 0-2 substitutions, every 29th
    with an N, every 41st under k (full-scan rows), both strands; a
    taxonomy over the references; the bytes of each run cached."""

    def __init__(self):
        rng = np.random.default_rng(61)
        self.refs, self.rheads = [], []
        refs = self.refs
        for f in range(160):
            anc = rng.choice(BASES, 600)
            for m in range(5):
                r = anc.copy()
                pos = rng.integers(0, 600, 6)
                r[pos] = BASES[rng.integers(0, 4, 6)]
                refs.append(r)
                self.rheads.append(b"f%03dm%d" % (f, m))
        self.reads, self.heads = [], []
        for i in range(N_READS):
            s = refs[int(rng.integers(0, len(refs)))]
            st = int(rng.integers(0, 500))
            r = s[st:st + 100].copy()
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(0, 100))] = BASES[int(rng.integers(0, 4))]
            if i % 29 == 7:
                r[int(rng.integers(0, 100))] = ord("N")
            if i % 41 == 3:
                r = r[:9].copy()
            self.reads.append(r)
            self.heads.append(b"q%03d" % i)
        self.rd = process_references(
            self.rheads, [r.copy() for r in refs], max_len_q=100,
            thres=THRES, rebase=True, rebase_amt=320, curate=2)
        self.acc = build_accelerator(self.rd, k=12, z=1)
        jengine.rd_acc_unit_index(self.rd, self.acc)
        self.prd, self.pacc = from_reference(self.rd, self.acc)
        tax = [(h, b"k__K;p__P%d;c__C%d" % (int(h[1:4]) % 3, int(h[1:4])))
               for h in self.rheads]
        self.jtax, self.ptax = JTaxonomy(tax), Taxonomy(tax)
        self.pieces = load_db(self.prd, self.pacc, score_matrix(),
                              "cpu").plan.pieces
        self.cache = {}

    def kw(self, mode):
        return dict(thres=THRES, mode=mode, do_rc=True, taxonomy=(
            (self.jtax, self.ptax) if mode == "CAPITALIST" else None))

    def jax(self, mode, accel=True, n=N_READS):
        """burst_tpu's bytes (resident, jax-CPU)."""
        key = ("jax", mode, accel, n)
        if key not in self.cache:
            kw = self.kw(mode)
            kw["taxonomy"] = kw["taxonomy"] and kw["taxonomy"][0]
            self.cache[key] = JAligner(
                self.rd, self.acc if accel else None, **kw).align_batch(
                self.heads[:n], [r.copy() for r in self.reads[:n]])
        return self.cache[key]

    def port(self, mode, accel=True, budget=None, n=N_READS):
        """(bytes, Aligner) of the port on the CPU under `budget`."""
        kw = self.kw(mode)
        kw["taxonomy"] = kw["taxonomy"] and kw["taxonomy"][1]
        al = Aligner(self.prd, self.pacc if accel else None, device="cpu",
                     tile_budget=budget, **kw)
        al.db.plan_rescore(4)           # as warmup(read_len=100) plans
        return al.align_batch(self.heads[:n],
                              [r.copy() for r in self.reads[:n]]), al

    def resident(self, mode, accel=True, n=N_READS):
        key = ("port", mode, accel, n)
        if key not in self.cache:
            got, al = self.port(mode, accel, n=n)
            assert not al.db.plan.streamed and "streamed" not in \
                al.last_stats
            self.cache[key] = got
        return self.cache[key]

    def budget(self, tables: bool, slot_rows: int = 200) -> int:
        """A budget that holds the tables (or not) and a ring of two
        slots of `slot_rows` rows of 448 + 32 bytes: every tile piece
        streams (each is larger than the two slots together)."""
        return score_matrix().nbytes + 2 * slot_rows * 480 + \
            (self.pieces[("tables",)] if tables else 0)


@pytest.fixture(scope="module")
def work():
    return _Work()


def _streamed_in_pieces(al, kinds=("slabs", "pieces")):
    """Every tile piece streamed, every phase-A bucket over 2 slots, and
    at least 3 uploads of each kind named."""
    st, plan, db = al.last_stats, al.db.plan, al.db
    assert not any(k[0] == "tiles" for k in plan.resident), plan.describe()
    assert plan.device_bytes <= plan.budget
    lbs, counts = np.unique(engine._unit_lb(db.rd), return_counts=True)
    for lb, n in zip(lbs, counts):
        assert n > 2 * db.slab_rows(int(lb) + engine.A_PAD), (lb, n)
    for kind in kinds:
        assert st[kind] >= 3, st
    assert st["h2d_bytes"] > 0
    return st


# ------------------------------------------------------------ (1) plan

def test_plan_default_on_the_cpu_is_resident(work):
    db = load_db(work.prd, work.pacc, score_matrix(), "cpu")
    db.plan_rescore(4)
    plan = db.plan
    assert plan.budget is None and plan.slot == 0 and db.ring is None
    assert plan.resident == set(plan.pieces) and plan.scour == "device"
    assert db.tiles_packed is not None and db.tabs is not None
    keys = list(plan.pieces)
    assert keys[0] == ("tables",) and keys[-1] == ("store",)
    # phase A's buckets, then the rescore copies, each smallest first
    tiles = keys[1:-1]
    assert [k[2] == engine.A_PAD for k in tiles] == [True, True, False,
                                                     False]
    assert [plan.pieces[k] for k in tiles[:2]] == sorted(
        plan.pieces[k] for k in tiles[:2])


@pytest.mark.parametrize("drop", range(7))
def test_plan_gives_way_in_order(work, drop):
    """Budgets that cut the keep order after each piece: the pieces give
    way from its end (store, rescore copies, phase A's buckets, tables),
    the device bytes stay within the budget, the scour route follows the
    tables."""
    pieces = state.database_pieces(work.prd, work.pacc, (4,))
    keys = list(pieces)
    fixed = score_matrix().nbytes
    widest = 448 + engine.rescore_pad(448, 16)
    reserve = 2 * state.SLAB_MIN_ROWS * widest
    held = keys[:len(keys) - drop]
    budget = fixed + reserve + sum(pieces[k] for k in held) + 100
    plan = state.plan_residency(pieces, budget, fixed, True, widest)
    assert [k for k in keys if plan.holds(k)] == held
    assert plan.device_bytes <= budget
    assert plan.scour == ("native" if drop == len(keys) else "device")
    assert (plan.why is None) == (drop < len(keys))
    streams = any(k[0] == "tiles" for k in keys[len(held):])
    assert (plan.slot >= state.SLAB_MIN_ROWS * widest) == streams
    assert (plan.slot == 0) == (not streams)


def test_plan_counts_every_piece(work):
    """Pieces that each fit the budget alone (the old per-piece check)
    but not together now plan to stream instead of overflowing; the
    budget under the least the database needs raises."""
    pieces = state.database_pieces(work.prd, work.pacc, (4,))
    tiles = {k: b for k, b in pieces.items() if k[0] == "tiles"}
    budget = sum(tiles.values()) // 2 + 3 * 16 * 1024
    assert all(b <= budget for b in tiles.values())
    plan = state.plan_residency(tiles, budget, 0, False, 960)
    assert plan.streamed and plan.device_bytes <= budget
    with pytest.raises(ValueError, match=r"needs at least \d+ bytes"):
        state.plan_residency(tiles, 2 * state.SLAB_MIN_ROWS * 960 - 1, 0,
                             False, 960)
    with pytest.raises(ValueError, match="needs at least"):
        load_db(work.prd, work.pacc, score_matrix(), "cpu", tile_budget=1000)


@pytest.mark.parametrize("case", ["no budget", "fits", "new ring",
                                  "ring"])
def test_place_piece_extends_the_plan(work, case):
    """A rescore copy no plan named joins the plan: resident where it
    fits beside the ring (or the room for two minimal slabs), else
    streamed, through a ring sized as plan_residency sizes it; the
    pieces placed before stay where they were, the device bytes within
    the budget."""
    pieces = state.database_pieces(work.prd, work.pacc, (4,))
    key, nb = next((k, b) for k, b in state.database_pieces(
        work.prd, work.pacc, (8,)).items() if k not in pieces)
    fixed = score_matrix().nbytes
    widest = 448 + engine.rescore_pad(448, 16)
    reserve = 2 * state.SLAB_MIN_ROWS * widest
    total = fixed + reserve + sum(pieces.values())
    budget = {"no budget": None, "fits": total + nb, "new ring": total,
              "ring": total - pieces[("store",)] - pieces[list(pieces)[-2]]
              }[case]
    plan = state.plan_residency(pieces, budget, fixed, True, widest)
    got = state.place_piece(plan, key, nb)
    assert got.holds(key) == (case in ("no budget", "fits"))
    assert got.resident - {key} == plan.resident
    assert list(got.pieces) == list(pieces) + [key]
    if budget is not None:
        assert got.device_bytes <= budget
    if case == "new ring":
        assert plan.slot == 0 and got.slot >= state.SLAB_MIN_ROWS * widest
        assert got.slot == min(state.RING_SLOT_MAX, (budget - fixed - sum(
            pieces[k] for k in plan.resident)) // 2)
    else:
        assert got.slot == plan.slot
    assert (plan.slot > 0) == (case == "ring")


@pytest.mark.parametrize("streams", [False, True])
def test_bucket_tiles_places_an_unnamed_copy(work, streams):
    """DeviceDB.bucket_tiles asked for a rescore copy no plan named
    extends the plan through place_piece: the tiles where it fits, None
    (it streams through the ring) where it does not."""
    db = load_db(work.prd, work.pacc, score_matrix(), "cpu",
                 tile_budget=work.budget(True) if streams else None)
    key = ("tiles", 448, engine.rescore_pad(448, 8))
    assert key not in db.plan.pieces
    got = db.bucket_tiles(448, key[2])
    assert key in db.plan.pieces and db.plan.holds(key) != streams
    assert (got is None) == streams and (db.ring is not None) == streams
    if streams:
        assert db.plan.device_bytes <= db.plan.budget
    else:
        assert got[1].shape[1] == 448 + key[2]


# --------------------------------------------- (2) accelerated, streamed

@pytest.mark.parametrize("mode", ["BEST", "ALLPATHS", "CAPITALIST", "ANY"])
def test_accel_streamed_matches_resident_and_jax(work, mode):
    # ANY: slots of 100 rows, under the winners of one (W, bucket) group
    got, al = work.port(mode, budget=work.budget(
        tables=True, slot_rows=100 if mode == "ANY" else 200))
    assert got == work.resident(mode) == work.jax(mode)
    assert got.count(b"\n") > N_READS // 2
    st = _streamed_in_pieces(al)
    plan = al.db.plan
    assert plan.scour == "device" and st["scour"] == "device"
    assert not plan.holds(("store",)) and al.db.tiles_packed is None
    assert st["blocks"] >= 2            # full-scan rows over K4 blocks
    if mode == "BEST":
        # the fused scan gave way: the two-step path at QBUNCH=1
        assert st["qbunch"] == 1 and "dev_pairs" not in st
    if mode == "ANY":
        # every hit under the threshold: some (W, bucket) group of
        # winners is cut into more than one piece
        groups = [k for k in st["streamed"] if k[1] != engine.A_PAD]
        assert st["pieces"] > len(groups)


# ---------------------------------------------------- (3) direct, blocks

@pytest.mark.parametrize("mode", ["BEST", "ANY"])
def test_direct_streamed_matches_resident_and_jax(work, mode):
    n = 12
    got, al = work.port(mode, accel=False, budget=work.budget(False), n=n)
    assert got == work.resident(mode, False, n) == work.jax(mode, False, n)
    assert got.count(b"\n") > n // 2
    st = _streamed_in_pieces(al, ("blocks", "pieces"))
    assert "scour" not in st and st["slabs"] == 0


# ------------------------------------------------ (4) two budgets, (5), (6)

def test_two_budgets_same_bytes(work):
    """The slab rotation: slabs of 200 and of 160 rows, the same
    bytes."""
    a, al_a = work.port("ALLPATHS", budget=work.budget(True, 160))
    b, al_b = work.port("ALLPATHS", budget=work.budget(True, 200))
    assert a == b == work.resident("ALLPATHS")
    assert al_a.db.ring.slot_bytes < al_b.db.ring.slot_bytes
    assert _streamed_in_pieces(al_a)["slabs"] > \
        _streamed_in_pieces(al_b)["slabs"]


@pytest.mark.parametrize("mode", ["BEST", "CAPITALIST"])
def test_native_scour_route(work, mode):
    """A budget under the tables: the plan routes the batch to the host
    scour at load time; the bytes are the device scour's."""
    got, al = work.port(mode, budget=work.budget(tables=False))
    assert got == work.resident(mode)
    plan = al.db.plan
    assert plan.scour == "native" and "tables" in plan.why
    assert al.db.tabs is None and not plan.holds(("tables",))
    st = _streamed_in_pieces(al)
    assert st["scour"] == "native"
    assert st["bunch_ov_rows"] == st["member_ov_rows"] == 0


def test_align_stream_under_budget(work):
    """Two batches in flight on worker threads share the ring; the
    bytes are sequential align_batch calls', streamed or resident."""
    kw = dict(work.kw("ALLPATHS"), taxonomy=None)
    al = Aligner(work.prd, work.pacc, device="cpu",
                 tile_budget=work.budget(True), **kw)
    al.warmup(read_len=100, n=8)
    batches = [(work.heads[i:i + 40], [r.copy() for r in
                                       work.reads[i:i + 40]])
               for i in (0, 40)]
    seq = [al.align_batch(h, s) for h, s in batches]
    _streamed_in_pieces(al, ("slabs",))
    assert list(al.align_stream(batches, depth=2)) == seq
    res = Aligner(work.prd, work.pacc, device="cpu", **kw)
    assert seq == [res.align_batch(h, s) for h, s in batches]


# ------------------------------------------ (7) burst_tpu's own slab path

_JAX_SLAB = """
import pickle, sys
from burst_tpu.accel import build_accelerator
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner
jsd.CHUNK_ROWS = 1024
jsd.CHUNK_BUNCH = 64
rheads, refs, heads, reads = pickle.load(open(sys.argv[1], "rb"))
rd = process_references(rheads, refs, max_len_q=100, thres=%r,
                        rebase=True, rebase_amt=320, curate=2)
acc = build_accelerator(rd, k=12, z=1)
out = Aligner(rd, acc, thres=%r, mode="BEST", do_rc=True).align_batch(
    heads, reads)
open(sys.argv[2], "wb").write(out)
"""


def test_burst_tpu_slab_path_matches_streamed(work, tmp_path):
    """burst_tpu with BURST_TPU_TILE_HBM_MB=0.0001 (K2 in slabs, the
    rescore over winner tiles, the fused scan given way) against the
    port's streamed BEST."""
    src, dst = tmp_path / "db.pkl", tmp_path / "out.b6"
    with open(src, "wb") as f:
        pickle.dump((work.rheads, work.refs, work.heads, work.reads), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               BURST_TPU_TILE_HBM_MB="0.0001")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SLAB % (THRES, THRES), str(src),
         str(dst)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got, al = work.port("BEST", budget=work.budget(tables=True))
    _streamed_in_pieces(al)
    assert dst.read_bytes() == got == work.resident("BEST")
