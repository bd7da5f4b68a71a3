"""Serving API: load a database onto the device once, align read
batches repeatedly.

    al = Aligner.from_artifacts("db.edx", "db.acx", thres=0.98,
                                do_rc=True, device="cuda")
    al.warmup(read_len=100)
    b6 = al.align_batch(headers, seqs)   # blast6 bytes, per batch

    al = Aligner.from_fasta("refs.fa", shear=320, mode="CAPITALIST")

Counterpart of `burst_tpu.serving.Aligner`: all five reporting modes,
with an accelerator or without; its output is byte-identical to
burst_tpu's for the same inputs.
"""
from __future__ import annotations

import io
import threading

import numpy as np
import torch

from . import devtime, engine, modes
from .alphabet import score_matrix
from .io.taxonomy import Taxonomy
from .parallel import mesh
from .process import RefData, bin_queries_for_accel, process_queries
from .state import load_db

MODES = ("BEST", "ALLPATHS", "FORAGE", "CAPITALIST", "ANY")
# `Aligner.counters`: batches, reads, (read, unit) pairs scanned by
# K1/K2, scour rows re-scoured on the host for overflowing the device
# slot budget
COUNTERS = ("batches", "reads", "pairs", "scour_overflow_rows")


def _batch_counts(stats: dict, reads: int) -> dict:
    """One batch's `COUNTERS` from its stats (`align_queries`)."""
    return {"batches": 1, "reads": reads,
            "pairs": sum(stats.get(k, 0)
                         for k in ("pairs", "dev_pairs", "side_pairs")),
            "scour_overflow_rows": sum(
                stats.get(k, 0)
                for k in ("ov_rows", "bunch_ov_rows", "member_ov_rows"))}


class Aligner:
    """Aligner over one database resident on `device` (a CUDA device
    runs the hand-written kernels; the CPU runs their plain versions).

    Without an accelerator (`acc=None`) every query is scanned against
    every unit (the direct path). With one, BEST mode runs the fused
    accelerated path at QBUNCH=1 (its report does not depend on the pod
    order), and every other mode -- and a BEST batch without a clear
    read of length >= k -- the two-step path: the device scour at the
    reference's batch-derived bunch width, then the candidate pairs
    through the pair kernel. `last_stats` holds the last accelerated
    batch's branch counts. Fused: rows re-scoured on the host for
    overflowing the slot budget (`ov_rows`), full-scan rows
    (`full_rows`), the pairs scanned on the fused device path
    (`dev_pairs`) and on the side branch (`side_pairs`), and `qbunch`
    (1). Two-step:
    `qbunch`, the overflowed bunch and member rows re-scoured on the
    host (`bunch_ov_rows`, `member_ov_rows`), `pairs` and `full_rows`.

    `tile_budget` bounds the database's device bytes (None: the card's
    memory less a working-set reserve, or BURST_TPU_TILE_HBM_MB; no
    limit on the CPU): what the residency plan (`db.plan`, see
    `state.plan_residency`) does not hold streams through a staging ring
    -- K2 in tile slabs, K3 over the winners' tiles, K4 in tile blocks
    -- and without device tables the batch is scoured on the host. Where
    the plan streams or scours on the host, `last_stats` (on every path)
    also holds the scour route (`scour`, with an accelerator), the
    streamed buckets (`streamed`, (length bucket, pad) pairs), the K2
    slabs, K4 blocks and K3 winner pieces uploaded (`slabs`, `blocks`,
    `pieces`) and the bytes copied host to device (`h2d_bytes`). A
    batch the native host scour served says so in `scour` ("native"):
    where the plan holds no device tables, under -hr, and where the
    caller asks for it (`align_batch(..., dev_scour=False)`).

    `last_stats` is whichever batch finished last; `counters` sums
    every batch's counts since construction (`COUNTERS`: batches,
    reads, K1/K2 pairs, overflowed scour rows), concurrent batches of
    `align_stream` included; a profiled batch's `burst.batch` span
    (`devtime.span`) carries its own."""

    def __init__(self, rd: RefData, acc=None, thres: float = 0.97,
                 mode: str = "BEST", do_rc: bool = False,
                 taxonomy: Taxonomy | None = None, z: int = 1,
                 taxacut: int = 10, taxasuppress: bool = False,
                 strict: bool = False,
                 device: torch.device | str = "cuda",
                 tile_budget: int | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode}")
        self.rd = rd
        self.acc = acc
        self.thres = thres
        self.mode = mode
        self.do_rc = do_rc
        self.taxonomy = taxonomy
        self.z = z
        self.taxacut = taxacut
        self.taxasuppress = taxasuppress
        self.strict = strict
        self.smat = score_matrix(z)
        self.db = load_db(rd, acc, self.smat, device, tile_budget)
        self.last_stats: dict = {}
        self._count_lock = threading.Lock()
        self._counts = dict.fromkeys(COUNTERS, 0)

    @classmethod
    def from_artifacts(cls, edx_path: str, acx_path: str | None = None,
                       tax_path: str | None = None, **kw):
        """Load persisted .edx (+.acx, +taxonomy TSV) artifacts."""
        from .accel import read_acx
        from .db import edx

        rd, _ = edx.read_edx(edx_path, xalpha=False)
        acc = read_acx(acx_path, z_required=kw.get("z", 1)) \
            if acx_path else None
        tax = Taxonomy.parse(tax_path) if tax_path else None
        return cls(rd, acc, taxonomy=tax, **kw)

    @classmethod
    def from_fasta(cls, ref_path: str, shear: int = 0, **kw):
        """Build the database in-process from a reference FASTA (no
        accelerator: the direct path)."""
        from .io.fasta import parse_fasta
        from .process import process_references

        rh, rs = parse_fasta(ref_path)
        rd = process_references(
            rh, rs, max_len_q=kw.pop("max_len_q", 320),
            thres=kw.get("thres", 0.97), rebase=shear > 0,
            rebase_amt=shear or 320, curate=2)
        return cls(rd, None, **kw)

    def warmup(self, read_len: int = 100, n: int = 256):
        """Plan the rescore's bucket tiles for reads of `read_len` (built
        where the residency plan holds them), then run one batch of
        random ACGT reads (kernel library loads, first-use allocations)."""
        self.db.plan_rescore(-(-read_len // 32))
        rng = np.random.default_rng(0)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        seqs = [rng.choice(bases, size=read_len) for _ in range(n)]
        heads = [f"w{i}".encode() for i in range(n)]
        self.align_batch(heads, seqs)

    def align_stream(self, batches, depth: int = 2,
                     alternate: bool = False):
        """Align an iterable of (headers, seqs) batches, yielding each
        batch's blast6 bytes in order, with up to `depth` batches in
        flight on worker threads so one batch's host work overlaps
        another's device work. Batches are independent, exactly as
        repeated align_batch calls; they share the database's staging
        ring under its lock, and a batch of reads longer than the plan
        had room for regrows it only once no other batch is in flight
        (`DeviceDB.batch`).

        `alternate` sends every other batch (the second, fourth, ...)
        through the native host scour (`dev_scour=False`), the others
        through the device scour, so that host and device scans of
        different batches can run at the same time. The bytes are the
        same either way."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, depth)) as ex:
            live = collections.deque()
            for i, batch in enumerate(batches):
                dev = (i % 2 == 0) if alternate else None
                live.append(ex.submit(self.align_batch, *batch,
                                      dev_scour=dev))
                while len(live) > depth:
                    yield live.popleft().result()
            while live:
                yield live.popleft().result()

    def align_batch(self, headers: list[bytes],
                    seqs: list[np.ndarray],
                    dev_scour: bool | None = None) -> bytes:
        """Align one batch of raw (ASCII) or translated reads; returns
        blast6 bytes. `dev_scour=False` scours this batch on the host
        (the native scour, no fused scan); True or None follows the
        residency plan (the device scour where it holds the tables). The
        bytes are the same either way."""
        with devtime.span("burst.batch") as sp:
            qd = process_queries(headers, seqs, self.thres, self.do_rc)
            buf = io.StringIO()
            # BEST's reporter does not depend on the pod order, so the
            # QBUNCH=1 fused scan is byte-safe there; the other modes
            # keep the reference's batch-derived bunch width
            best = self.mode == "BEST"
            _, stats = align_queries(
                qd, self.db, self.mode, modes.B6Writer(buf),
                qbunch=1 if best else engine.default_qbunch(len(qd.seqs),
                                                            1),
                fuse=best, z=self.z, taxonomy=self.taxonomy,
                taxacut=self.taxacut, taxasuppress=self.taxasuppress,
                strict=self.strict, dev_scour=dev_scour)
            out = buf.getvalue().encode("latin-1")
            counts = _batch_counts(stats, len(headers))
            if sp is not None:
                sp.counts = counts
        self.last_stats = stats
        self._count(counts)
        return out

    def _count(self, got: dict):
        with self._count_lock:
            for key, n in got.items():
                self._counts[key] += n

    @property
    def counters(self) -> dict:
        """Totals over every batch since the Aligner was built
        (`COUNTERS`), concurrent batches included."""
        with self._count_lock:
            return dict(self._counts)


def align_queries(qd, db, mode: str, writer, qbunch: int, fuse: bool,
                  z: int = 1, heur: bool = False, skip_ambig: bool = False,
                  taxonomy: Taxonomy | None = None, taxacut: int = 10,
                  taxasuppress: bool = False, strict: bool = False,
                  mark=lambda name: None, dev_scour: bool | None = None,
                  shards: int | None = None,
                  qshards: int = 1) -> tuple[str, dict]:
    """Align the batch `qd` on `db` in `mode`, its b6 rows through
    `writer`: the flow of `Aligner.align_batch` and of the CLI. With an
    accelerator, the fused scan where `fuse` is set, -hr (`heur`) is off,
    QBUNCH (`qbunch`) is 1 and the batch is not sharded, else the
    two-step path at `qbunch`; ANY prints in the visit order of that
    QBUNCH. Without one, the direct path. `skip_ambig` is -sa at align
    time; `dev_scour=False` scours on the host (no fused scan);
    `mark(name)` ends each of the CLI's phases.

    `shards` (not None) runs burst_tpu's sharded flow on a
    (qshards x shards) grid, 1 x 1 included (`parallel.mesh`; the cards
    in turn, or the database's device repeated off the card): with an
    accelerator phase A through `compute_ed_matrix_accel_sharded` and
    phase B through `rescore_winners_sharded` (ANY reports unsharded
    from the sharded phase A); without one `compute_ed_matrix_sharded`
    in every mode, then the unsharded rescore. The CLI passes `shards`
    only for --shards above 1, so its --qshards alone shards nothing,
    as in burst_tpu.

    Returns (path, stats): path "fused", "two-step" or "direct"; stats
    the accelerated branch's counts (`Aligner`), and where the residency
    plan streams or scours on the host the batch's streaming counts;
    `regrow` where the batch's reads were longer than any the plan had
    room for (`DeviceDB.fit_words`: their Myers words and the ring's new
    slot bytes); on a grid `grid` ([q shards, db shards]), `devices`
    (distinct devices) and the mesh's route_s, scan_s, merge_s,
    pairs_per_shard, win_pairs and full_pairs, and `slab_bytes` (the
    device bytes of every slab the database's grids hold: one copy of
    the database for each grid and pad, phase B's pad a Myers width's)."""
    rd, acc = db.rd, db.acc
    visits = ed = sel = None
    stats: dict = {}
    sharded = shards is not None
    mstats: dict | None = None
    devs = None
    if sharded:
        devs = mesh.grid_devices(db.device, shards * qshards)
        grid = mesh.make_mesh2(shards, qshards, devs)
        mstats = {"grid": [qshards, shards],
                  "devices": len({str(d) for d in grid.ravel()})}
    W = int(engine._query_matrix(qd)[2].max()) if len(qd.seqs) else 1
    # the plan holds still while the batch runs (`DeviceDB.batch`)
    with db.batch(W) as grew:
        regrow = {"words": W, "slot": db.plan.slot} if grew else None
        if acc is None:
            path = "direct"
            if sharded:
                ed = mesh.compute_ed_matrix_sharded(
                    qd, db, shards, q_shards=qshards, devices=devs)
            elif mode == "ANY":
                ed = engine.compute_ed_matrix(qd, db)
            else:
                # streamed running-min selection, never the dense
                # [numUnibins, tot_units] matrix (burst.c:4318-4521)
                sel = engine.compute_ed_select(qd, db, mode)
        else:
            qbins = bin_queries_for_accel(qd, acc.k, z, heur)
            fused = engine.accel_scan_fused(qd, db, qbins, qbunch,
                                            skip_ambig, dev_scour) \
                if fuse and not heur and not sharded else None
            if fused is not None:
                path = "fused"
                visits, ed, stats = fused
                mark("Accelerator scour")
            else:
                path = "two-step"
                visits = engine.accel_candidates(qd, db, qbins, heur,
                                                 qbunch=qbunch,
                                                 skip_ambig=skip_ambig,
                                                 dev_scour=dev_scour)
                mark("Accelerator scour")
                if sharded:
                    ed = mesh.compute_ed_matrix_accel_sharded(
                        qd, db, visits, shards, qshards, stats=mstats,
                        devices=devs)
                else:
                    ed = engine.compute_ed_matrix_accel(qd, db, visits)
                stats = dict(visits.stats or {}, qbunch=visits.qbunch,
                             pairs=len(ed.pj), full_rows=len(ed.full_rows))
        mark("Alignment phase A")
        if mode == "ANY":
            with devtime.span("burst.report"):
                if visits is not None:
                    modes.report_any_accel(ed, visits, qd, db, writer,
                                           qbunch=qbunch)
                else:
                    modes.report_any(ed, qd, db, writer)
            mark("Reporting")
            return path, _batch_stats(stats, qd, db, regrow, mstats)
        pod_order = win_cols = None
        with devtime.span("burst.select"):
            if visits is not None:
                juni, refpos, eds = engine.select_pods(qd, rd, ed, mode)
                pod_order = engine.accel_pod_order(qd, rd, visits, juni,
                                                   refpos)
                win_cols = ed.lookup_cols(juni, refpos, rd.tot_units)
            elif sel is None:               # the sharded dense matrix
                juni, refpos, eds = engine.select_pods(qd, rd, ed, mode)
            else:
                juni, refpos, eds = sel
        if sharded and visits is not None:
            pods = mesh.rescore_winners_sharded(
                qd, db, juni, refpos, eds, mode, shards, pod_order, qshards,
                stats=mstats, win_cols=win_cols, devices=devs)
        else:
            pods = engine.rescore_winners(qd, db, juni, refpos, eds, mode,
                                          pod_order, win_cols=win_cols)
        with devtime.span("burst.report"):
            if mode in ("ALLPATHS", "FORAGE"):
                modes.report_allpaths_or_forage(
                    pods, qd, rd, writer, taxonomy,
                    forage=(mode == "FORAGE"))
            elif mode == "BEST":
                modes.report_best(pods, qd, rd, writer, taxonomy,
                                  taxasuppress, strict)
            else:
                modes.report_capitalist(pods, qd, rd, writer, taxonomy,
                                        taxacut, taxasuppress, strict)
        mark("Rescore + reporting")
        return path, _batch_stats(stats, qd, db, regrow, mstats)


def _batch_stats(stats: dict, qd, db, regrow, mstats=None) -> dict:
    # the batch's own scour route ahead of the plan's
    got = dict(_stream_counts(qd, db), **stats)
    if regrow is not None:
        got["regrow"] = regrow
    if mstats is not None:
        got.update(mstats)
        if "pairs_per_shard" in got:
            got["pairs_per_shard"] = got["pairs_per_shard"].tolist()
    return got


def _stream_counts(qd, db) -> dict:
    """The batch's streaming counts where the plan streams or scours on
    the host (else none)."""
    plan = db.plan
    if not (plan.streamed or plan.scour == "native"):
        return {}
    st = engine._stream_stats(qd)
    got = dict(streamed=sorted(st["streamed"]), slabs=st["slabs"],
               blocks=st["blocks"], pieces=st["pieces"],
               h2d_bytes=st["h2d_bytes"])
    if plan.scour is not None:
        got["scour"] = plan.scour
    return got
