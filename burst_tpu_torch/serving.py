"""Serving API: load a database onto the device once, align read
batches repeatedly (BEST mode with an accelerator).

    al = Aligner.from_artifacts("db.edx", "db.acx", thres=0.98,
                                do_rc=True, device="cuda")
    al.warmup(read_len=100)
    b6 = al.align_batch(headers, seqs)   # blast6 bytes, per batch

Counterpart of `burst_tpu.serving.Aligner` for the slice this package
ports; its output is byte-identical to burst_tpu's for the same inputs.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.io.taxonomy import Taxonomy
from burst_tpu.process import RefData, bin_queries_for_accel, \
    process_queries

from . import engine, modes
from .state import load_db


class Aligner:
    """Aligner over one database resident on `device` (a CUDA device
    runs the hand-written kernels; the CPU runs their plain versions).
    `last_stats` holds the last batch's branch counts: rows re-scoured
    on the host for overflowing the slot budget (`ov_rows`), and the
    pairs scanned on the fused device path and on the side branch."""

    def __init__(self, rd: RefData, acc, thres: float = 0.97,
                 mode: str = "BEST", do_rc: bool = False,
                 taxonomy: Taxonomy | None = None, z: int = 1,
                 taxasuppress: bool = False, strict: bool = False,
                 device: torch.device | str = "cuda"):
        if mode != "BEST":
            raise NotImplementedError(
                f"mode {mode}: only BEST is ported; ALLPATHS, FORAGE, "
                "CAPITALIST and ANY need the two-step accelerated path "
                "(ROADMAP M7)")
        if acc is None:
            raise NotImplementedError(
                "no accelerator (.acx): the direct path needs the dense "
                "cross kernel (ROADMAP M8, K4)")
        self.rd = rd
        self.acc = acc
        self.thres = thres
        self.mode = mode
        self.do_rc = do_rc
        self.taxonomy = taxonomy
        self.z = z
        self.taxasuppress = taxasuppress
        self.strict = strict
        self.smat = score_matrix(z)
        self.db = load_db(rd, acc, self.smat, device)
        self.last_stats: dict = {}

    @classmethod
    def from_artifacts(cls, edx_path: str, acx_path: str | None = None,
                       tax_path: str | None = None, **kw):
        """Load persisted .edx (+.acx, +taxonomy TSV) artifacts."""
        from burst_tpu.accel import read_acx
        from burst_tpu.db import edx

        rd, _ = edx.read_edx(edx_path, xalpha=False)
        acc = read_acx(acx_path, z_required=kw.get("z", 1)) \
            if acx_path else None
        tax = Taxonomy.parse(tax_path) if tax_path else None
        return cls(rd, acc, taxonomy=tax, **kw)

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
        qbins = bin_queries_for_accel(qd, self.acc.k, self.z)
        visits, ed, stats = engine.accel_scan_fused(qd, self.db, qbins)
        juni, refpos, eds = engine.select_pods(qd, ed)
        pod_order = engine.accel_pod_order(qd, self.rd, visits, juni,
                                           refpos)
        win_cols = ed.lookup_cols(juni, refpos, self.rd.tot_units)
        pods = engine.rescore_winners(qd, self.db, juni, refpos, eds,
                                      pod_order, win_cols)
        buf = io.StringIO()
        modes.report_best(pods, qd, self.rd, modes.B6Writer(buf),
                          self.taxonomy, self.taxasuppress, self.strict)
        self.last_stats = stats
        return buf.getvalue().encode("latin-1")
