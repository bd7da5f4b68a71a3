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

import numpy as np
import torch

from . import engine, modes
from .alphabet import score_matrix
from .io.taxonomy import Taxonomy
from .process import RefData, bin_queries_for_accel, process_queries
from .state import load_db

MODES = ("BEST", "ALLPATHS", "FORAGE", "CAPITALIST", "ANY")


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
    (`full_rows`), and the pairs scanned on the fused device path
    (`dev_pairs`) and on the side branch (`side_pairs`). Two-step:
    `qbunch`, the overflowed bunch and member rows re-scoured on the
    host (`bunch_ov_rows`, `member_ov_rows`), `pairs` and `full_rows`."""

    def __init__(self, rd: RefData, acc=None, thres: float = 0.97,
                 mode: str = "BEST", do_rc: bool = False,
                 taxonomy: Taxonomy | None = None, z: int = 1,
                 taxacut: int = 10, taxasuppress: bool = False,
                 strict: bool = False,
                 device: torch.device | str = "cuda"):
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
        self.db = load_db(rd, acc, self.smat, device)
        self.last_stats: dict = {}

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
        """Build the rescore's bucket tiles for reads of `read_len`, then
        run one batch of random ACGT reads (kernel library loads,
        first-use allocations)."""
        W = -(-read_len // 32)
        for lb in np.unique(engine._unit_lb(self.rd)):
            self.db.bucket_tiles(int(lb), engine.rescore_pad(int(lb), W))
        rng = np.random.default_rng(0)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        seqs = [rng.choice(bases, size=read_len) for _ in range(n)]
        heads = [f"w{i}".encode() for i in range(n)]
        self.align_batch(heads, seqs)

    def align_stream(self, batches, depth: int = 2):
        """Align an iterable of (headers, seqs) batches, yielding each
        batch's blast6 bytes in order, with up to `depth` batches in
        flight on worker threads so one batch's host work overlaps
        another's device work. Batches are independent, exactly as
        repeated align_batch calls."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, depth)) as ex:
            live = collections.deque()
            for batch in batches:
                live.append(ex.submit(self.align_batch, *batch))
                while len(live) > depth:
                    yield live.popleft().result()
            while live:
                yield live.popleft().result()

    def align_batch(self, headers: list[bytes],
                    seqs: list[np.ndarray]) -> bytes:
        """Align one batch of raw (ASCII) or translated reads; returns
        blast6 bytes."""
        qd = process_queries(headers, seqs, self.thres, self.do_rc)
        mode = self.mode
        buf = io.StringIO()
        writer = modes.B6Writer(buf)
        visits = ed = None
        if self.acc is not None:
            qbins = bin_queries_for_accel(qd, self.acc.k, self.z)
            # BEST's reporter does not depend on the pod order, so the
            # QBUNCH=1 fused scan is byte-safe there; the other modes
            # keep the reference's batch-derived bunch width
            fused = engine.accel_scan_fused(qd, self.db, qbins) \
                if mode == "BEST" else None
            if fused is not None:
                visits, ed, self.last_stats = fused
            else:
                visits = engine.accel_candidates(
                    qd, self.db, qbins,
                    qbunch=1 if mode == "BEST" else None)
                ed = engine.compute_ed_matrix_accel(qd, self.db, visits)
                self.last_stats = dict(
                    visits.stats or {}, qbunch=visits.qbunch,
                    pairs=len(ed.pj), full_rows=len(ed.full_rows))
        elif mode == "ANY":
            ed = engine.compute_ed_matrix(qd, self.db)
        if mode == "ANY":
            if isinstance(ed, engine.SparseED):
                modes.report_any_accel(ed, visits, qd, self.db, writer)
            else:
                modes.report_any(ed, qd, self.db, writer)
            return buf.getvalue().encode("latin-1")
        pod_order = win_cols = None
        if visits is not None:
            juni, refpos, eds = engine.select_pods(qd, self.rd, ed, mode)
            pod_order = engine.accel_pod_order(qd, self.rd, visits, juni,
                                               refpos)
            win_cols = ed.lookup_cols(juni, refpos, self.rd.tot_units)
        else:
            # direct path: streamed selection, no dense matrix
            juni, refpos, eds = engine.compute_ed_select(qd, self.db, mode)
        pods = engine.rescore_winners(qd, self.db, juni, refpos, eds, mode,
                                      pod_order, win_cols=win_cols)
        if mode in ("ALLPATHS", "FORAGE"):
            modes.report_allpaths_or_forage(
                pods, qd, self.rd, writer, self.taxonomy,
                forage=(mode == "FORAGE"))
        elif mode == "BEST":
            modes.report_best(pods, qd, self.rd, writer, self.taxonomy,
                              self.taxasuppress, self.strict)
        else:
            modes.report_capitalist(pods, qd, self.rd, writer,
                                    self.taxonomy, self.taxacut,
                                    self.taxasuppress, self.strict)
        return buf.getvalue().encode("latin-1")
