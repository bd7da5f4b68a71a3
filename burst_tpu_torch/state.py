"""The port's device state for one database.

`load_db` takes the numpy `RefData` and `Accelerator` that both
packages share (built by `burst_tpu.process` / `burst_tpu.accel`, or
read from .edx/.acx) and builds the device tensors the slice reads:
the scour's postings tables, the nibble-packed all-units tile store,
the per-length-bucket tile matrices, and the score table.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from burst_tpu.accel import build_unit_index
from burst_tpu.native import _unit_ids_clump_grouped, load_host

from . import engine
from .kernels import scour_device


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
        self.tabs = scour_device.get_tables(acc, device)
        self.tiles_packed, self.lp_all = engine._tiles_device_all(rd,
                                                                  device)
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
    """Device state for (rd, acc) on `device`. Raises NotImplementedError
    for databases outside the slice: no unit-granular clump-grouped
    index, or a tile store over the device's resident budget."""
    device = torch.device(device)
    if load_host() is None:
        raise RuntimeError("the burst_tpu native host library (g++ "
                           "build of burst_tpu/native) is required")
    build_unit_index(rd, acc)
    if acc.u_csr is None or not _unit_ids_clump_grouped(acc.u_csr,
                                                        engine.VECSZ):
        raise NotImplementedError(
            "accelerators without clump-grouped unit postings need the "
            "two-step accelerated path (ROADMAP M7)")
    lbs = engine._unit_lb(rd)
    lbmax = int(lbs.max()) if rd.tot_units else 64
    engine._check_budget(
        engine._pow2_ceil(max(1, rd.tot_units)) * (-(-(lbmax + 32) // 2)),
        device, "all-units tile store")
    db = DeviceDB(rd, acc, smat, device)
    for lb in np.unique(lbs):       # the side-pair kernel's tiles (K2)
        db.bucket_tiles(int(lb), 32)
    return db
