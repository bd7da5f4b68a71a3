"""Device-side k-mer scour fused with the phase-A pair scan, as PyTorch
ops.

Counterpart of `burst_tpu.kernels.scour_device` (`_scour_core`,
`_scour_reduce`, `compact`, `ScourTables`, `get_tables`,
`_chunk_dispatch`, `_chunk_finish`, `scour_align_rows`) for the
single-member-bunch case (QBUNCH=1, clear rows): every (query, k-mer
window) pair expands its unit postings into a fixed-width slot matrix
[rows, E]; one row sort and segmented scans recover per-unit hit counts
(the per-unit pigeonhole filter), per-clump hit counts and per-clump
first-touch words (candidate order hits desc, min word asc, clump asc).
Winners are compacted into fixed buffers, and the passing units go
straight into the K1 pair kernel against the nibble-packed all-units
store. Rows whose postings exceed the slot budget E are flagged (`ov`)
for an exact host re-scour.

Translation notes (the JAX version's TPU-shaped steps):
  * the (unit, word<<1|mask) sort key packs into one int64
    (unit << 32 | key2), so one sort replaces lax.sort's two keys;
  * the slot -> owning window map is one batched searchsorted over each
    row's postings cumsum, not a loop over the T windows;
  * the segmented min of first-touch words is a scatter_reduce("amin")
    onto run ids, exact at every run end (the only place it is read);
  * winners compact through a cumsum target scatter, with no host sync.

Knobs shared with burst_tpu: BURST_TPU_SCOUR_E (slots per row, default
256) and BURST_TPU_SCOUR_CHUNK (rows per chunk, default 4096).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import devtime
from .myers import build_peq_dev
from .myers_cuda import myers_pairs_packed

VECSZ = 16
DEAD = 2**31 - 1     # sort sentinel: above every live unit id


def chunk_rows() -> int:
    return int(os.environ.get("BURST_TPU_SCOUR_CHUNK", 4096))


def slot_budget() -> int:
    return int(os.environ.get("BURST_TPU_SCOUR_E", 256))


class ScourTables:
    """Postings tables on the device, built once per accelerator.

    k <= 13: dense word -> rank table (one gather per window); k = 14/15:
    sorted nonzero words, looked up by binary search. `cap_factor`
    (winner buffers per chunk row) grows 2 -> 4 once a chunk overflows
    and stays there."""

    def __init__(self, u_csr, k: int, device: torch.device):
        n_nz = len(u_csr.nzw)
        if k <= 13:
            rank = np.zeros(1 << (2 * k), dtype=np.int32)
            rank[u_csr.nzw] = np.arange(1, n_nz + 1, dtype=np.int32)
            self.rank = torch.from_numpy(rank).to(device)
            self.nzw = None
        else:
            self.rank = None
            self.nzw = torch.from_numpy(
                u_csr.nzw.astype(np.int64)).to(device)
        start = np.zeros(n_nz + 1, dtype=np.int64)
        start[1:] = u_csr.start
        cnt = np.zeros(n_nz + 1, dtype=np.int64)
        cnt[1:] = u_csr.cnt
        self.start = torch.from_numpy(start).to(device)
        self.cnt = torch.from_numpy(cnt).to(device)
        self.ids = torch.from_numpy(
            u_csr.ids.astype(np.int32, copy=False)).to(device)
        self.cap_factor = 2


def get_tables(acc, device: torch.device) -> ScourTables:
    """Device tables for an accelerator with its unit index built."""
    if acc.k > 15 or acc.u_csr is None:
        raise NotImplementedError(
            f"device scour needs k <= 15 and a unit index (k={acc.k})")
    if len(acc.u_csr.ids) >= 2**31:
        raise NotImplementedError("over 2^31 unit postings: int32 ids")
    return ScourTables(acc.u_csr, acc.k, device)


def _scour_core(qmat, lens, tabs: ScourTables, mm_member, mm_inner,
                k: int, E: int, CAPC: int, CAPU: int):
    """Slot expansion + reduction for one chunk of clear rows."""
    n, L = qmat.shape
    dev = qmat.device
    T = L - k + 1
    q = qmat.long() - 1
    w = torch.zeros((n, T), dtype=torch.int64, device=dev)
    for i in range(k):                       # w_t = sum q[t+i] 4^(k-1-i)
        w = w * 4 + q[:, i:i + T]
    valid_t = torch.arange(T, device=dev)[None, :] <= (lens - k)[:, None]
    if tabs.nzw is None:
        r = tabs.rank[w.clamp(0, tabs.rank.shape[0] - 1)].long()
    else:
        loc = torch.searchsorted(tabs.nzw, w)
        locc = loc.clamp(max=tabs.nzw.shape[0] - 1)
        r = torch.where(tabs.nzw[locc] == w, locc + 1, 0)
    s = tabs.start[r]
    c = torch.where(valid_t, tabs.cnt[r], 0)
    cum = c.cumsum(dim=1)
    total = cum[:, -1]
    ov = total > E
    e = torch.arange(E, device=dev).expand(n, E).contiguous()
    # owning window of slot e: the first t with cum[t] > e
    te = torch.searchsorted(cum, e, right=True)
    tc = te.clamp(max=T - 1)
    prev = torch.where(te > 0, cum.gather(1, (te - 1).clamp(min=0)), 0)
    ws = s.gather(1, tc)
    wv = w.gather(1, tc)
    live = e < total.clamp(max=E)[:, None]
    pos = torch.where(live, ws + (e - prev), 0)
    u = tabs.ids[pos].long()
    return _scour_reduce(u, te, wv, live, ov, mm_member, mm_inner, CAPC,
                         CAPU)


def _run_starts(v, live):
    n = v.shape[0]
    head = torch.ones((n, 1), dtype=torch.bool, device=v.device)
    start = torch.cat([head, v[:, 1:] != v[:, :-1]], dim=1) & live
    end = torch.cat([v[:, 1:] != v[:, :-1], head], dim=1) & live
    return start, end


def _scour_reduce(u, te, wv, live, ov, mm_member, mm_inner,
                  CAPC: int, CAPU: int):
    """Expanded slots (unit u, owning window te, word wv, live mask) ->
    compacted clump candidates and passing unit keys."""
    n, E = u.shape
    dev = u.device
    cl = u // VECSZ
    # first slot of each (window, clump) run in expansion order: the
    # native walk adds a word's weight once per clump transition
    same = (te[:, 1:] == te[:, :-1]) & (cl[:, 1:] == cl[:, :-1])
    mask_new = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                          ~same], dim=1) & live
    key = torch.where(live, (u << 32) | ((wv << 1) | mask_new.long()),
                      (DEAD << 32) | DEAD)
    key = key.sort(dim=1).values
    su = key >> 32
    sk2 = key & 0xFFFFFFFF
    slive = su < DEAD
    sw = sk2 >> 1
    sm = sk2 & 1
    scl = su // VECSZ
    idx = torch.arange(E, device=dev).expand(n, E)

    u_start, u_end = _run_starts(su, slive)
    last_ustart = torch.where(u_start, idx, -1).cummax(dim=1).values
    uh = idx - last_ustart + 1                       # run length at ends

    cl_start, cl_end = _run_starts(scl, slive)
    cmask = sm.cumsum(dim=1)
    zstart = torch.where(cl_start, cmask - sm, -1).cummax(dim=1).values
    hits_cl = cmask - zstart
    # min word per clump run, exact at the run end
    run = cl_start.long().cumsum(dim=1) - 1
    gid = (torch.arange(n, device=dev)[:, None] * E + run.clamp(min=0)
           ).reshape(-1)
    segmin = torch.full((n * E,), DEAD, dtype=torch.int64, device=dev)
    segmin = segmin.scatter_reduce(
        0, gid, torch.where(slive, sw, DEAD).reshape(-1), "amin")
    minw = segmin[gid].reshape(n, E)

    okrow = ~ov[:, None]
    cwin = cl_end & (hits_cl > mm_member[:, None]) & okrow
    uwin = u_end & (uh > mm_inner[:, None]) & okrow
    jrow = torch.arange(n, device=dev)[:, None].expand(n, E)
    ccount, (cj, ccl, chits, cminw) = compact(
        cwin, [jrow, scl, hits_cl, minw], CAPC)
    ucount, (uj, uu) = compact(uwin, [jrow, su], CAPU)
    return ov, ccount, cj, ccl, chits, cminw, ucount, uj, uu


def compact(mask, cols, cap: int):
    """Masked elements in row-major order, in fixed [cap] buffers (zero
    past the count); returns (count, buffers). The count may exceed cap:
    the caller checks."""
    flat = mask.reshape(-1)
    tgt = torch.where(flat, flat.long().cumsum(0) - 1, cap).clamp(max=cap)
    outs = []
    for c in cols:
        buf = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
        buf.scatter_(0, tgt, torch.where(flat, c.reshape(-1), 0))
        outs.append(buf[:cap])
    return flat.sum(), outs


def _chunk_dispatch(qmat, lens, k, mm_member, mm_inner, tabs, tot_units,
                    E, align_ctx, cap_factor: int):
    """Run the fused scour + K1 over fixed-size row chunks; returns
    ([(c0, rows_in_chunk, device results)], qp_d, lp_d)."""
    dev = tabs.ids.device
    smat_dev, tiles_packed, W = align_ctx
    n = len(lens)
    L = qmat.shape[1]
    C = chunk_rows()
    npad = max(C, -(-n // C) * C)
    cap = cap_factor * C
    qp = np.zeros((npad, L), dtype=np.uint8)
    qp[:n] = qmat
    lp = np.zeros(npad, dtype=np.int64)
    lp[:n] = lens
    mmm = np.full(npad, DEAD, dtype=np.int64)
    mmm[:n] = np.minimum(mm_member, DEAD - 1)
    mmi = np.full(npad, DEAD, dtype=np.int64)
    mmi[:n] = np.minimum(mm_inner, DEAD - 1)
    qp_d = torch.from_numpy(qp).to(dev)
    lp_d = torch.from_numpy(lp).to(dev)
    mmm_d = torch.from_numpy(mmm).to(dev)
    mmi_d = torch.from_numpy(mmi).to(dev)
    out = []
    for c0 in range(0, npad, C):
        nr = min(C, max(0, n - c0))
        qm, ln = qp_d[c0:c0 + C], lp_d[c0:c0 + C]
        res = _scour_core(qm, ln, tabs, mmm_d[c0:c0 + C],
                          mmi_d[c0:c0 + C], k, E, cap, cap)
        uj, uu = res[7], res[8]
        peq = build_peq_dev(qm, ln, smat_dev, W)
        tidx = uu.clamp(0, tot_units - 1).to(torch.int32)
        packed = myers_pairs_packed(peq, tiles_packed,
                                    uj.to(torch.int32), tidx, W)
        out.append((c0, nr, res + (packed,)))
    return out, qp_d, lp_d


def _chunk_finish(chunks, n, tot_units, cap_factor: int):
    """One fetch over every chunk, merged to global row indices. Raises
    RuntimeError when any chunk's winner buffers overflowed."""
    cap = cap_factor * chunk_rows()
    fetched = devtime.fetch([r for _, _, r in chunks])
    ov = np.zeros(n, dtype=bool)
    keys = ("cj", "ccl", "chits", "cminw", "ukeys", "uj", "uu", "ped",
            "pfirst", "plast")
    parts = {key: [] for key in keys}
    for (c0, nr, _), h in zip(chunks, fetched):
        ovc, ccount, cj, ccl, chits, cminw, ucount, uj, uu, packed = h
        nc, nu = int(ccount), int(ucount)
        if nc > cap or nu > cap:
            raise RuntimeError("device scour buffer overflow")
        ov[c0:c0 + nr] = ovc[:nr]
        parts["cj"].append(cj[:nc] + c0)
        parts["ccl"].append(ccl[:nc])
        parts["chits"].append(chits[:nc])
        parts["cminw"].append(cminw[:nc])
        parts["ukeys"].append((uj[:nu] + c0) * tot_units + uu[:nu])
        parts["uj"].append(uj[:nu] + c0)
        parts["uu"].append(uu[:nu])
        parts["ped"].append(np.minimum(packed[0][:nu].astype(np.int64),
                                       255))
        parts["pfirst"].append(packed[1][:nu].astype(np.int64))
        parts["plast"].append(packed[2][:nu].astype(np.int64))
    out = {"ov": ov}
    for key in keys:
        out[key] = np.concatenate(parts[key]).astype(np.int64) \
            if parts[key] else np.zeros(0, np.int64)
    return out


def scour_align_rows(qmat: np.ndarray, lens: np.ndarray, k: int,
                     mm_member: np.ndarray, mm_inner: np.ndarray,
                     tabs: ScourTables, tot_units: int, smat_dev,
                     tiles_packed: torch.Tensor, W: int,
                     E: int | None = None):
    """Fused scour + phase-A pair scan for `n` clear rows.

    Returns a finish() closure yielding a dict: `ov` [n] overflow flags,
    candidate tuples `cj`/`ccl`/`chits`/`cminw` (hits > mm_member),
    passing unit keys `ukeys` (ascending), their pairs `uj`/`uu`, and the
    pairs' K1 results `ped`/`pfirst`/`plast`. finish.batch_dev holds the
    uploaded (query matrix, lengths) for reuse."""
    if E is None:
        E = slot_budget()
    n = len(lens)
    factor = tabs.cap_factor
    ctx = (smat_dev, tiles_packed, W)
    chunks, qp_d, lp_d = _chunk_dispatch(qmat, lens, k, mm_member,
                                         mm_inner, tabs, tot_units, E, ctx,
                                         factor)

    def finish():
        try:
            return _chunk_finish(chunks, n, tot_units, factor)
        except RuntimeError:
            if factor >= 4:
                raise
            # sticky escalation: this DB/workload needs bigger winner
            # buffers; redo once and remember for later batches
            tabs.cap_factor = 4
            ch2, _, _ = _chunk_dispatch(qmat, lens, k, mm_member, mm_inner,
                                        tabs, tot_units, E, ctx, 4)
            return _chunk_finish(ch2, n, tot_units, 4)

    finish.batch_dev = (qp_d, lp_d)
    return finish
