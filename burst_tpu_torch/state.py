"""The port's device state for one database.

`load_db` takes the package's numpy `RefData` and, for the accelerated
path, its `Accelerator` (built by `process` / `accel`, or read from
.edx/.acx), decides once where each piece of the database lives (the
residency plan, `DeviceDB.plan`) and builds the device tensors the plan
holds: the per-length-bucket tile matrices and the score table, and
with an accelerator also the scour's postings tables and the
nibble-packed all-units tile store. What the plan does not hold streams
from host memory through the `DeviceDB`'s staging ring
(`devtime.StagingRing`), or takes the host route set out in
`plan_residency`.

`from_reference` carries a database built by burst_tpu (the JAX package
this one was ported from) across: its `RefData` / `Accelerator` are
plain containers of numpy arrays and lists, so the port's own classes
take the same fields without copying the arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch

from . import devtime, engine
from .accel import Accelerator, SparseCSR, build_unit_index
from .kernels import scour_device
from .kernels.myers import xalpha_smat
from .native import load_host
from .process import RefData

SLAB_MIN_ROWS = 8           # rows of the smallest slab, block or piece
PLAN_W = 16                 # Myers words of the reads a plan first admits
RING_SLOT_MAX = 64 << 20    # bytes of one staging ring slot at most
# card bytes the default budget leaves to a batch's working set (Peq
# planes, the scour's slot matrices, results): the largest batch peak
# over the resident database seen on an H100 is 3.9 GiB (PERF.md 5)
WORKING_SET_RESERVE = 8 << 30
A_PAD = engine.A_PAD


@dataclasses.dataclass
class Residency:
    """Where each piece of a database lives: plain data.

    `pieces` maps each piece to its device bytes (power-of-two rows
    included), in the order in which they are kept; `resident` holds
    the keys the device holds. Keys: ("tables",) the scour's postings
    tables, ("tiles", lb, pad) a length bucket's tiles at `pad` pad
    columns (pad 32: phase A's; else a rescore copy), ("store",) the
    nibble-packed all-units store. `fixed` counts the score table;
    `slot` is the staging ring's slot bytes (two of them on the device;
    0 where nothing streams; at least `min_slot`). `scour` is "device",
    or "native" where the tables are not held (`why` says why); None
    without an accelerator. `plan_residency` makes a plan and
    `place_piece` extends one; nothing else decides residency.
    """
    budget: int | None
    pieces: dict
    resident: set
    fixed: int = 0
    slot: int = 0
    scour: str | None = None
    why: str | None = None
    min_slot: int = 0

    def holds(self, key) -> bool:
        return key in self.resident

    @property
    def streamed(self) -> list:
        """The tile pieces that stream, in keep order."""
        return [k for k in self.pieces
                if k[0] == "tiles" and k not in self.resident]

    @property
    def device_bytes(self) -> int:
        """Resident pieces, the score table and the ring's two slots."""
        return self.fixed + 2 * self.slot + sum(
            self.pieces[k] for k in self.resident)

    def describe(self) -> str:
        def name(k):
            return k[0] if len(k) == 1 else f"{k[0]} {k[1]}+{k[2]}"
        held = ", ".join(f"{name(k)} {self.pieces[k]}" for k in self.pieces
                         if k in self.resident)
        off = ", ".join(f"{name(k)} {self.pieces[k]}" for k in self.pieces
                        if k not in self.resident)
        return (f"budget {self.budget} bytes, {self.device_bytes} on the "
                f"device (ring slots 2 x {self.slot}); resident: "
                f"{held or 'nothing'}; not resident: {off or 'nothing'}; "
                f"scour {self.scour}" + (f" ({self.why})" if self.why
                                         else ""))


def default_budget(device: torch.device) -> int | None:
    """The device bytes a database may take: BURST_TPU_TILE_HBM_MB (MiB)
    where set; else on a CUDA device its memory less the working-set
    reserve, and None (no limit) on the CPU. The variable keeps
    burst_tpu's name but not its scope: there it bounds each tile bucket
    alone; here it bounds all the database's device pieces together
    (tables, packed store, bucket tiles and the staging ring), so a value
    too small for those raises ValueError (`plan_residency`)."""
    env = os.environ.get("BURST_TPU_TILE_HBM_MB")
    if env:
        return int(float(env) * (1 << 20))
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1] - WORKING_SET_RESERVE


def plan_residency(pieces: dict, budget: int | None, fixed: int = 0,
                   accel: bool = False, widest: int = 0) -> Residency:
    """Decide which pieces stay resident under `budget` bytes.

    `pieces` (key -> bytes) in keep order: the scour's tables first,
    then phase A's buckets, then the rescore copies, the packed store
    last (each class smallest first). Pieces give way from the end of
    that order until the rest fits: first the store (only the fused path
    is lost: BEST goes down the two-step path), then the rescore copies
    and phase A's buckets, largest first (they stream through a staging
    ring of two slots), the tables last (with `accel`, the batch is then
    scoured on the host, `scour` = "native", as it is where the tables
    have no device form and `pieces` holds none). Under a budget the
    plan always leaves
    room for two slabs of SLAB_MIN_ROWS rows of `widest` bytes (the
    widest tile row a batch can ask for): the ring's two slots where a
    piece streams -- each takes half of what the resident pieces leave,
    up to RING_SLOT_MAX -- else room for a rescore copy that no plan
    named (`place_piece`). Raises ValueError where the budget cannot
    hold the score table and those two slabs."""
    keys = list(pieces)
    min_slot = SLAB_MIN_ROWS * widest
    if budget is None:
        return _scour_route(Residency(budget, dict(pieces), set(keys),
                                      fixed, 0), accel)
    if fixed + 2 * min_slot > budget:
        raise ValueError(
            f"a budget of {budget} bytes cannot hold this database: it "
            f"needs at least {fixed + 2 * min_slot} bytes (the score "
            f"table and two slabs of {SLAB_MIN_ROWS} rows of its widest "
            f"tiles, {widest} bytes a row)")
    cut = len(keys)
    while fixed + 2 * min_slot + sum(pieces[k] for k in keys[:cut]) > \
            budget:
        cut -= 1
    held = keys[:cut]
    slot = 0
    if any(k[0] == "tiles" for k in keys[cut:]):
        slot = _ring_slot(budget, fixed, sum(pieces[k] for k in held))
    return _scour_route(Residency(budget, dict(pieces), set(held), fixed,
                                  slot, min_slot=min_slot), accel)


def _ring_slot(budget: int, fixed: int, held: int) -> int:
    """A ring slot: half of what the score table and the `held` bytes of
    resident pieces leave of the budget, up to RING_SLOT_MAX."""
    return min(RING_SLOT_MAX, (budget - fixed - held) // 2)


def place_piece(plan: Residency, key, nbytes: int) -> Residency:
    """`plan` with one piece more (a rescore copy no plan named), the
    pieces it placed left where they are: the new one is resident where
    it fits in what the budget leaves beside the ring's two slots (or
    the room for two minimal slabs that `plan_residency` keeps where
    nothing streams), else it streams, through a ring sized as
    `plan_residency` sizes it where the plan had none."""
    held = sum(plan.pieces[k] for k in plan.resident)
    room = None if plan.budget is None else \
        plan.budget - plan.fixed - held - 2 * max(plan.slot, plan.min_slot)
    resident, slot = set(plan.resident), plan.slot
    if room is None or nbytes <= room:
        resident.add(key)
    elif not slot:
        slot = _ring_slot(plan.budget, plan.fixed, held)
    return dataclasses.replace(plan, pieces={**plan.pieces, key: nbytes},
                               resident=resident, slot=slot)


def _scour_route(plan: Residency, accel: bool) -> Residency:
    if accel:
        plan.scour = "device" if plan.holds(("tables",)) else "native"
        if ("tables",) not in plan.pieces:
            plan.why = ("no device form: k > 15, 2^31 unit postings, or "
                        "unit postings that are not clump-grouped")
        elif plan.scour == "native":
            plan.why = "the tables give way to the budget"
    return plan


def _tile_bytes(n: int, width: int) -> int:
    return engine._pow2_ceil(max(1, n)) * width


def _store_bytes(rd) -> int:
    lbmax = int(engine._unit_lb(rd).max()) if rd.tot_units else 64
    return engine._pow2_ceil(max(1, rd.tot_units)) * (-(-(lbmax + A_PAD)
                                                         // 2))


def widest_row(rd, W: int) -> int:
    """Bytes of the widest tile row a batch of reads of up to W Myers
    words can ask for: the longest length bucket at the rescore's pad
    for such a read."""
    lbmax = int(engine._unit_lb(rd).max()) if rd.tot_units else 64
    return lbmax + max(A_PAD, engine.rescore_pad(lbmax, W))


def database_pieces(rd, acc, rescore_ws=()) -> dict:
    """(key -> device bytes) of every piece of (rd, acc), in keep order
    (see plan_residency)."""
    lbs, counts = np.unique(engine._unit_lb(rd), return_counts=True)
    lbs, counts = lbs[lbs > 0], counts[lbs > 0]     # 0: another rank's
    out = {}
    if acc is not None and scour_device.has_device_form(acc):
        out[("tables",)] = scour_device.table_bytes(acc.u_csr, acc.k)
    a = {("tiles", int(lb), A_PAD): _tile_bytes(int(n), int(lb) + A_PAD)
         for lb, n in zip(lbs, counts)}
    r = {}
    for W in sorted(set(rescore_ws)):
        for lb, n in zip(lbs, counts):
            pad = engine.rescore_pad(int(lb), W)
            if pad != A_PAD:
                r[("tiles", int(lb), pad)] = _tile_bytes(int(n), int(lb)
                                                         + pad)
    for cls in (a, r):
        out.update(sorted(cls.items(), key=lambda kv: (kv[1], kv[0])))
    if acc is not None:
        out[("store",)] = _store_bytes(rd)
    return out


class DeviceDB:
    """Device state for one database under its residency plan (see the
    module docstring). Resident bucket tiles are keyed by (length
    bucket, pad columns); a streamed bucket keeps its host tile matrix
    (its rows exactly, no power-of-two padding) cached here. A rescore
    copy that no plan named (a read length `warmup` did not name) joins
    the plan through `place_piece`. Streaming batches run on worker
    threads: the maps build under a lock, and the staging ring has its
    own.

    The plan keeps room for the rescore rows of reads up to `plan_w`
    Myers words (PLAN_W, 512 bp, at first): two slabs of SLAB_MIN_ROWS
    of the widest such row. A batch of longer reads regrows that room
    before its first copy (`batch`, `fit_words`): the plan is made again
    for its W, so the ring's two slots hold its widest rescore rows, and
    pieces give way where the budget asks for it. A regrowth waits until
    no other batch is in flight (`align_stream` runs batches on worker
    threads), and holds back new batches until it is done."""

    def __init__(self, rd, acc, smat: np.ndarray, device: torch.device,
                 budget: int | None, xalpha: bool = False):
        self.rd = rd
        self.acc = acc
        self.xalpha = xalpha
        self.smat = smat
        self.device = device
        self.budget = budget
        self.smat_dev = torch.from_numpy(np.ascontiguousarray(smat)
                                         ).to(device)
        self._smat_x_dev = None
        self.tabs = self.tiles_packed = self.lp_all = None
        self.ring = None
        self.plan = None
        self._buckets: dict = {}
        self._host: dict = {}
        self._lock = threading.Lock()
        # batches in flight, and whether a regrowth waits for or holds
        # the plan (`batch`)
        self._gate = threading.Condition()
        self._in_flight = 0
        self._regrowing = False
        self.rescore_ws: set = set()
        self.plan_w = PLAN_W
        self._replan()

    def check_alphabet(self, qd):
        """Raises ValueError unless the batch `qd` is of the database's
        alphabet: raw bytes (-x) on a raw-byte database, codes on a
        coded one. The tiles' format, and so the Peq tables' code count,
        follow the database."""
        if qd.xalpha != self.xalpha:
            raise ValueError(
                f"queries of {'raw bytes' if self.xalpha else 'codes'} "
                "expected: the database was loaded with xalpha="
                f"{self.xalpha}")

    def peq_smat(self, qd) -> torch.Tensor:
        """The device score table that the batch `qd`'s Peq tables are
        built from: the database's 16-code table, or on a raw-byte
        database (-x) the 256-code table of byte equality (built at
        first use). Raises ValueError for a batch of the other
        alphabet."""
        self.check_alphabet(qd)
        if not self.xalpha:
            return self.smat_dev
        if self._smat_x_dev is None:
            self._smat_x_dev = torch.from_numpy(xalpha_smat()).to(
                self.device)
        return self._smat_x_dev

    def plan_rescore(self, W: int):
        """Plan the rescore copies for queries of W Myers words as well
        (`Aligner.warmup`). Only between batches: a piece that now gives
        way is freed."""
        self.rescore_ws.add(int(W))
        self._replan()

    @contextlib.contextmanager
    def batch(self, W: int):
        """Hold the plan for one batch of reads of up to W Myers words:
        first make room for them (`fit_words`), then keep any regrowth
        waiting until the batch ends. Yields whether it replanned."""
        grew = self.fit_words(W)
        with self._gate:
            self._gate.wait_for(lambda: not self._regrowing)
            self._in_flight += 1
        try:
            yield grew
        finally:
            with self._gate:
                self._in_flight -= 1
                self._gate.notify_all()

    def fit_words(self, W: int) -> bool:
        """Make room for a batch of reads of up to W Myers words before
        its first copy: where W passes what the plan was made for, plan
        again for W (the ring's slots grow to two slabs of the widest
        rescore row of such reads), once no batch is in flight (`batch`)
        and no other regrowth runs. Without a budget there is nothing to
        make room in. Returns whether it replanned."""
        if W <= self.plan_w:
            return False
        if self.budget is None:
            with self._gate:
                self.plan_w = max(self.plan_w, int(W))
            return False
        with self._gate:
            self._gate.wait_for(lambda: not self._regrowing)
            if W <= self.plan_w:        # another batch regrew for it
                return False
            self._regrowing = True
            self._gate.wait_for(lambda: self._in_flight == 0)
        try:
            was, self.plan_w = self.plan_w, int(W)
            try:
                self._replan()
            except ValueError:      # the budget cannot hold such rows
                self.plan_w = was
                raise
            return True
        finally:
            with self._gate:
                self._regrowing = False
                self._gate.notify_all()

    def _replan(self):
        """Plan the database with rescore copies for `rescore_ws`, then
        hold what the plan holds: build what is newly resident, free
        what gave way."""
        # a raw-byte database (-x) has no scour tables or packed store:
        # the accelerator indexes none of its queries, and the nibble
        # store cannot hold a raw byte
        acc = None if self.xalpha else self.acc
        pieces = database_pieces(self.rd, acc, self.rescore_ws)
        plan = plan_residency(
            pieces, self.budget, self.smat.nbytes, acc is not None,
            widest_row(self.rd, max([self.plan_w, *self.rescore_ws])))
        with self._lock:
            self._apply(plan)

    def _apply(self, plan: Residency):
        for key in [k for k in self._buckets if not plan.holds(k)]:
            del self._buckets[key]
        if not plan.holds(("store",)):
            self.tiles_packed = self.lp_all = None
        if not plan.holds(("tables",)):
            self.tabs = None
        if self.ring is not None and self.ring.slot_bytes != plan.slot:
            self.ring = None
        if plan.slot and self.ring is None:
            self.ring = devtime.StagingRing(plan.slot, self.device)
        if plan.holds(("tables",)) and self.tabs is None:
            self.tabs = scour_device.get_tables(self.acc, self.device)
        for key in plan.pieces:
            if key[0] == "tiles" and plan.holds(key) and \
                    key not in self._buckets:
                self._build(key)
        if plan.holds(("store",)) and self.tiles_packed is None:
            self.tiles_packed, self.lp_all = engine._tiles_device_all(
                self.rd, self.device)
        self.plan = plan

    def _build(self, key):
        _, lb, pad = key
        mat, pos2row = engine._tile_matrix(self.rd, lb, pad)
        self._buckets[key] = (pos2row, torch.from_numpy(mat).to(
            self.device))

    def bucket_tiles(self, lb: int, pad: int):
        """(sorted position -> row map, [pow2 rows, lb+pad] uint8 device
        tiles) of one unit length bucket the plan holds, or None where
        it streams. A rescore copy no plan named joins the plan here
        (`place_piece`)."""
        key = ("tiles", int(lb), int(pad))
        with self._lock:
            if key not in self.plan.pieces:
                nb = _tile_bytes(int(np.count_nonzero(
                    engine._unit_lb(self.rd) == lb)), lb + pad)
                self._apply(place_piece(self.plan, key, nb))
            return self._buckets.get(key)

    def host_tiles(self, lb: int, pad: int):
        """(host [n, lb+pad] uint8 tile matrix of the bucket's n units,
        sorted position -> row map) of a streamed bucket, cached."""
        key = (int(lb), int(pad))
        with self._lock:
            got = self._host.get(key)
            if got is None:
                got = self._host[key] = engine._tile_matrix(
                    self.rd, lb, pad, pow2=False)
        return got

    def slab_rows(self, width: int) -> int:
        """Rows of `width` bytes that one ring slot holds."""
        return max(1, self.ring.slot_bytes // width)


def load_db(rd, acc, smat: np.ndarray, device,
            tile_budget: int | None = None,
            xalpha: bool = False) -> DeviceDB:
    """Device state for (rd, acc) on `device`; acc=None builds the direct
    path's state only (bucket tiles and the score table), as does a
    database of raw bytes (`xalpha`, -x), whose queries the accelerator
    never indexes. `tile_budget` bounds the database's device bytes
    (None: `default_budget`); what does not fit streams or takes the
    host scour (`plan_residency`), as do unit postings that are not
    clump-grouped (they have no device form: `has_device_form`). Raises
    ValueError for a budget under the least the database needs."""
    device = torch.device(device)
    if load_host() is None:
        raise RuntimeError("the native host library (g++ build of "
                           "burst_tpu_torch/native) is required")
    if acc is not None and not xalpha:
        build_unit_index(rd, acc)
    budget = default_budget(device) if tile_budget is None else tile_budget
    return DeviceDB(rd, acc, smat, device, budget, xalpha)


def _copy_csr(csr) -> SparseCSR | None:
    return None if csr is None else SparseCSR(csr.nzw, csr.cnt, csr.ids)


def from_reference(rd, acc=None):
    """(RefData, Accelerator | None) of this package holding the same
    fields -- the very same arrays and lists -- as burst_tpu's `rd` and
    `acc`. Per-object caches (tile matrices, device tables) are not
    carried over: each package builds its own."""
    own = RefData(**{f.name: getattr(rd, f.name)
                     for f in dataclasses.fields(RefData)})
    if getattr(rd, "unit_range", None) is not None:
        own.unit_range = rd.unit_range      # host-range .edx shard
    own_acc = None
    if acc is not None:
        own_acc = Accelerator(acc.k, _copy_csr(acc.csr), acc.bad, acc.z)
        own_acc.u_csr = _copy_csr(acc.u_csr)
    return own, own_acc
