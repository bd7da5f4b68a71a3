"""The port's device state for one database.

`load_db` takes the package's numpy `RefData` and, for the accelerated
path, its `Accelerator` (built by `process` / `accel`, or read from
.edx/.acx) and builds the device tensors the aligner reads: the
per-length-bucket tile matrices and the score table, and with an
accelerator also the scour's postings tables and the nibble-packed
all-units tile store.

`from_reference` carries a database built by burst_tpu (the JAX package
this one was ported from) across: its `RefData` / `Accelerator` are
plain containers of numpy arrays and lists, so the port's own classes
take the same fields without copying the arrays.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from . import engine
from .accel import Accelerator, SparseCSR, build_unit_index
from .kernels import scour_device
from .native import _unit_ids_clump_grouped, load_host
from .process import RefData


class DeviceDB:
    """Device-resident database state (see module docstring). Bucket
    tiles are keyed by (length bucket, pad columns); the rescore's pad
    depends on the batch's Myers word count, so those build on first
    use, under a lock (streaming batches run on worker threads)."""

    def __init__(self, rd, acc, smat: np.ndarray, device: torch.device):
        self.rd = rd
        self.acc = acc
        self.smat = smat
        self.device = device
        self.smat_dev = torch.from_numpy(np.ascontiguousarray(smat)
                                         ).to(device)
        self.tabs = self.tiles_packed = self.lp_all = None
        if acc is not None:
            self.tabs = scour_device.get_tables(acc, device)
            self.tiles_packed, self.lp_all = engine._tiles_device_all(
                rd, device)
        self._buckets: dict = {}
        self._lock = threading.Lock()

    def bucket_tiles(self, lb: int, pad: int):
        """(sorted position -> row map, [pow2 rows, lb+pad] uint8 device
        tiles) of one unit length bucket."""
        key = (lb, pad)
        with self._lock:
            got = self._buckets.get(key)
            if got is None:
                nbkt = int(np.count_nonzero(engine._unit_lb(self.rd) == lb))
                engine._check_budget(nbkt * (lb + pad), self.device,
                                     f"length bucket {lb}")
                mat, pos2row = engine._tile_matrix(self.rd, lb, pad)
                got = self._buckets[key] = (
                    pos2row, torch.from_numpy(mat).to(self.device))
        return got


def load_db(rd, acc, smat: np.ndarray, device) -> DeviceDB:
    """Device state for (rd, acc) on `device`; acc=None builds the direct
    path's state only (bucket tiles and the score table). Raises
    NotImplementedError for databases outside the port: no unit-granular
    clump-grouped index, or a tile store over the device's resident
    budget."""
    device = torch.device(device)
    if load_host() is None:
        raise RuntimeError("the native host library (g++ build of "
                           "burst_tpu_torch/native) is required")
    lbs = engine._unit_lb(rd)
    if acc is not None:
        build_unit_index(rd, acc)
        if acc.u_csr is None or not _unit_ids_clump_grouped(acc.u_csr,
                                                            engine.VECSZ):
            raise NotImplementedError(
                "accelerators without clump-grouped unit postings have no "
                "device scour; the host scour pass that serves them comes "
                "with ROADMAP M12")
        lbmax = int(lbs.max()) if rd.tot_units else 64
        engine._check_budget(
            engine._pow2_ceil(max(1, rd.tot_units))
            * (-(-(lbmax + 32) // 2)), device, "all-units tile store")
    db = DeviceDB(rd, acc, smat, device)
    for lb in np.unique(lbs):       # phase A's tiles (K2 and K4)
        db.bucket_tiles(int(lb), 32)
    return db


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
