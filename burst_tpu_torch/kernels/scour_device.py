"""Device-side k-mer scour, alone or fused with the phase-A pair scan,
as PyTorch ops.

Counterpart of `burst_tpu.kernels.scour_device` (`_scour_core`,
`_scour_core_words`, `_scour_reduce`, `compact`, `ScourTables`,
`get_tables`, `_chunk_dispatch`, `_chunk_finish`, `scour_rows`,
`scour_bunch_rows`, `scour_align_rows`): every (row, word) pair expands
its unit postings into a fixed-width slot matrix [rows, E]; one row sort
and segmented scans recover per-unit hit counts (the per-unit pigeonhole
filter), per-clump hit counts and per-clump first-touch words (candidate
order hits desc, min word asc, clump asc). Winners are compacted into
fixed buffers. A row is either one clear query, its words the k-mers of
its windows (`scour_rows`; `scour_align_rows` also sends the passing
units straight into the K1 pair kernel against the nibble-packed
all-units store), or one bunch of queries, its words an explicit deduped
list weighted by the MAX multiplicity over the members
(`scour_bunch_rows`, QBUNCH > 1). Rows whose postings exceed the slot
budget E are flagged (`ov`) for an exact host re-scour.

Translation notes (the JAX version's TPU-shaped steps):
  * the (unit, word<<1|mask) sort key packs into one int64
    (unit << 32 | key2), so one sort replaces lax.sort's two keys;
  * the slot -> owning window map is one batched searchsorted over each
    row's postings cumsum, not a loop over the T windows;
  * the segmented min of first-touch words is a scatter_reduce("amin")
    onto run ids, exact at every run end (the only place it is read);
  * winners compact through a cumsum target scatter, with no host sync.

The slot budgets follow the database: a word cut from a sequence like
the database's own posts `ScourTables.depth` units on average, so a row
of T words gets T x depth slots and a margin (at least 256 a query row
and 4096 a bunch row, burst_tpu's fixed defaults), and a chunk as many
rows as keep its slot matrix near SLOT_TARGET entries. burst_tpu's knobs
override them: BURST_TPU_SCOUR_E (slots per query row),
BURST_TPU_SCOUR_CHUNK (query rows per chunk, at most 4096 unset),
BURST_TPU_SCOUR_EB (slots per bunch row) and BURST_TPU_SCOUR_BCHUNK
(bunch rows per chunk, at most 512 unset).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import devtime
from ..native import _unit_ids_clump_grouped
from .myers import build_peq_dev
from .myers_cuda import myers_pairs_packed

VECSZ = 16
DEAD = 2**31 - 1     # sort sentinel: above every live unit id


# Slots over a row's expected postings (T words x ScourTables.depth). A
# read's postings spread about that mean with its place in the database
# (the deepest of 800 reads stood 1.24 times over it in a database of
# 80-member amplicon families and 1.52 times in one of 10-member 25 kbp
# families); a bunch's word list is the union of up to 16 reads' and
# spreads less (0.97 and 1.01 times).
SLOT_MARGIN = 1.5
BUNCH_SLOT_MARGIN = 1.25
SLOT_TARGET = 3 << 22      # entries of one chunk's [rows, E] slot matrix


def _derived_budget(tabs, nwords: int, margin: float, floor: int) -> int:
    need = int(np.ceil(margin * nwords * tabs.depth))
    return max(floor, -(-need // 256) * 256)


def _env_int(name: str):
    val = os.environ.get(name)
    return int(val) if val else None


def slot_budget(tabs, nwords: int) -> int:
    """Slots of a query row of up to `nwords` words."""
    return _env_int("BURST_TPU_SCOUR_E") or _derived_budget(
        tabs, nwords, SLOT_MARGIN, 256)


def bunch_slot_budget(tabs, nwords: int) -> int:
    """Slots of a bunch row whose word list holds up to `nwords`."""
    return _env_int("BURST_TPU_SCOUR_EB") or _derived_budget(
        tabs, nwords, BUNCH_SLOT_MARGIN, 4096)


def chunk_rows(E: int) -> int:
    """Query rows of one chunk at E slots a row."""
    return _env_int("BURST_TPU_SCOUR_CHUNK") or \
        max(1, min(4096, SLOT_TARGET // E))


def bunch_chunk_rows(E: int) -> int:
    """Bunch rows of one chunk at E slots a row."""
    return _env_int("BURST_TPU_SCOUR_BCHUNK") or \
        max(1, min(512, SLOT_TARGET // E))


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


class BufferOverflow(RuntimeError):
    """A chunk's winners did not fit its compaction buffers; `need` is
    the largest winner count of any chunk."""

    def __init__(self, need: int):
        super().__init__("device scour buffer overflow")
        self.need = need


class ScourTables:
    """Postings tables on the device, built once per accelerator.

    k <= 13: dense word -> rank table (one gather per window); k = 14/15:
    sorted nonzero words, looked up by binary search. `depth` is the
    number of units that a word posts, averaged over the database's own
    words (each weighted by its postings: a read cut from a sequence like
    the database's meets a word as often as the database holds it); the
    slot budgets are sized from it. `cap_factor`
    (winner buffer entries per chunk row) grows 2 -> 4 once a chunk
    overflows, further where 4 is not enough, and stays there;
    `cap_factor_bunch` is the same for bunch rows, which win far more
    clumps a row than a query row does."""

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
        total = float(u_csr.cnt.sum())
        self.depth = float(np.square(u_csr.cnt.astype(np.float64)).sum()
                           / total) if total else 0.0
        self.cap_factor = 2
        self.cap_factor_bunch = 2

    def rank_of(self, w):
        """1-based rank of each word among the nonzero words, 0 where it
        has no postings."""
        if self.nzw is None:
            return self.rank[w.clamp(0, self.rank.shape[0] - 1)].long()
        loc = torch.searchsorted(self.nzw, w)
        locc = loc.clamp(max=self.nzw.shape[0] - 1)
        return torch.where(self.nzw[locc] == w, locc + 1, 0)


def has_device_form(acc) -> bool:
    """Whether the accelerator's unit postings have device tables: k <=
    15, a unit index whose postings are clump-grouped (every word's
    ascending, as burst_tpu's device scour requires), and ids that int32
    holds (under 2^31 postings). The residency plan sends the others to
    the native host scour, which walks postings that are not
    clump-grouped the slow way, as burst_tpu's does."""
    return acc.k <= 15 and acc.u_csr is not None and \
        len(acc.u_csr.ids) < 2**31 and \
        _unit_ids_clump_grouped(acc.u_csr, VECSZ)


def table_bytes(u_csr, k: int) -> int:
    """Device bytes of the ScourTables of `u_csr`."""
    n_nz = len(u_csr.nzw)
    rank = 4 << (2 * k) if k <= 13 else 8 * n_nz
    return rank + 16 * (n_nz + 1) + 4 * len(u_csr.ids)


def get_tables(acc, device: torch.device) -> ScourTables:
    """Device tables for an accelerator with a device form (see
    `has_device_form`; the residency plan routes the others past this)."""
    if not has_device_form(acc):
        raise ValueError(f"no device form of these postings (k={acc.k}); "
                         "the residency plan routes them to the host scour")
    return ScourTables(acc.u_csr, acc.k, device)


def _expand_slots(w, valid_t, tabs: ScourTables, E: int):
    """Words [n, T] (valid where `valid_t`) -> their unit postings laid
    out in [n, E] slots, in word order then posting order. Returns (unit
    u, owning word index te, the same clamped to a valid column tc, word
    value wv, live mask, row overflow flags ov)."""
    n, T = w.shape
    dev = w.device
    r = tabs.rank_of(w)
    s = tabs.start[r]
    c = torch.where(valid_t, tabs.cnt[r], 0)
    cum = c.cumsum(dim=1)
    total = cum[:, -1]
    ov = total > E
    e = torch.arange(E, device=dev).expand(n, E).contiguous()
    # owning word of slot e: the first t with cum[t] > e
    te = torch.searchsorted(cum, e, right=True)
    tc = te.clamp(max=T - 1)
    prev = torch.where(te > 0, cum.gather(1, (te - 1).clamp(min=0)), 0)
    ws = s.gather(1, tc)
    wv = w.gather(1, tc)
    live = e < total.clamp(max=E)[:, None]
    pos = torch.where(live, ws + (e - prev), 0)
    u = tabs.ids[pos].long()
    return u, te, tc, wv, live, ov


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
    u, te, _, wv, live, ov = _expand_slots(w, valid_t, tabs, E)
    return _scour_reduce(u, te, wv, None, live, ov, mm_member, mm_inner,
                         CAPC, CAPU)


def _scour_core_words(wmat, nw, wgt, tabs: ScourTables, mm_member,
                      mm_inner, E: int, CAPC: int, CAPU: int):
    """Scour over explicit per-row word lists with per-word weights (the
    QBUNCH > 1 bunch scour: one row per bunch, words deduped with the MAX
    multiplicity over the members, burst.c:4096-4119)."""
    T = wmat.shape[1]
    valid_t = torch.arange(T, device=wmat.device)[None, :] < nw[:, None]
    u, te, tc, wv, live, ov = _expand_slots(wmat, valid_t, tabs, E)
    return _scour_reduce(u, te, wv, wgt.gather(1, tc), live, ov,
                         mm_member, mm_inner, CAPC, CAPU)


def _run_starts(v, live):
    n = v.shape[0]
    head = torch.ones((n, 1), dtype=torch.bool, device=v.device)
    start = torch.cat([head, v[:, 1:] != v[:, :-1]], dim=1) & live
    end = torch.cat([v[:, 1:] != v[:, :-1], head], dim=1) & live
    return start, end


def _scour_reduce(u, te, wv, wg, live, ov, mm_member, mm_inner,
                  CAPC: int, CAPU: int):
    """Expanded slots (unit u, owning window te, word wv, live mask) ->
    compacted clump candidates and passing unit keys. wg=None counts
    every slot once (one row per query); with wg each slot carries its
    word's weight, the bunch's MAX-multiplicity contribution
    (burst.c:3258-3284)."""
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
    if wg is None:
        key = key.sort(dim=1).values
    else:
        # equal keys are one word's posting of one unit: equal weights
        key, perm = key.sort(dim=1)
    su = key >> 32
    sk2 = key & 0xFFFFFFFF
    slive = su < DEAD
    sw = sk2 >> 1
    sm = sk2 & 1
    scl = su // VECSZ
    idx = torch.arange(E, device=dev).expand(n, E)

    u_start, u_end = _run_starts(su, slive)
    if wg is None:
        last_ustart = torch.where(u_start, idx, -1).cummax(dim=1).values
        uh = idx - last_ustart + 1                   # run length at ends
        smw = sm
    else:
        swg = torch.where(slive, wg.gather(1, perm), 0)
        ucum = swg.cumsum(dim=1)
        uzst = torch.where(u_start, ucum - swg, -1).cummax(dim=1).values
        uh = ucum - uzst                             # weighted run sum
        smw = sm * swg

    cl_start, cl_end = _run_starts(scl, slive)
    cmask = smw.cumsum(dim=1)
    zstart = torch.where(cl_start, cmask - smw, -1).cummax(dim=1).values
    hits_cl = cmask - zstart
    if wg is not None:
        # the native walk saturates the accumulated hits at 0xFFFF;
        # positive weights make the final clamp equivalent
        hits_cl = hits_cl.clamp(max=0xFFFF)
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


def _saturate(mm, npad: int, dev):
    """Thresholds padded to `npad` rows on the device; values of 1 << 60
    ("no winners") and the pad rows are clipped under the sort sentinel,
    so `hits > mm` keeps its meaning for every live slot."""
    out = np.full(npad, DEAD, dtype=np.int64)
    out[: len(mm)] = np.minimum(mm, DEAD - 1)
    return torch.from_numpy(out).to(dev)


def _chunk_dispatch(qmat, lens, k, mm_member, mm_inner, tabs, tot_units,
                    E, C, align_ctx, cap_factor: int):
    """Run the scour (with `align_ctx`: fused with K1) over chunks of C
    rows; returns ([(c0, rows_in_chunk, device results)], qp_d,
    lp_d)."""
    dev = tabs.ids.device
    n = len(lens)
    L = qmat.shape[1]
    npad = max(C, -(-n // C) * C)
    cap = cap_factor * C
    qp = np.zeros((npad, L), dtype=np.uint8)
    qp[:n] = qmat
    lp = np.zeros(npad, dtype=np.int64)
    lp[:n] = lens
    qp_d = torch.from_numpy(qp).to(dev)
    lp_d = torch.from_numpy(lp).to(dev)
    mmm_d = _saturate(mm_member, npad, dev)
    mmi_d = _saturate(mm_inner, npad, dev)
    out = []
    for c0 in range(0, npad, C):
        nr = min(C, max(0, n - c0))
        qm, ln = qp_d[c0:c0 + C], lp_d[c0:c0 + C]
        res = _scour_core(qm, ln, tabs, mmm_d[c0:c0 + C],
                          mmi_d[c0:c0 + C], k, E, cap, cap)
        if align_ctx is not None:
            smat_dev, tiles_packed, W = align_ctx
            uj, uu = res[7], res[8]
            peq = build_peq_dev(qm, ln, smat_dev, W)
            tidx = uu.clamp(0, tot_units - 1).to(torch.int32)
            res += (myers_pairs_packed(peq, tiles_packed,
                                       uj.to(torch.int32), tidx, W),)
        out.append((c0, nr, res))
    return out, qp_d, lp_d


def _chunk_finish(chunks, n, tot_units, cap: int, aligned: bool):
    """One fetch over every chunk, merged to global row indices. Raises
    BufferOverflow when any chunk's winners exceeded `cap`."""
    fetched = devtime.fetch([r for _, _, r in chunks])
    need = max([int(h[i]) for h in fetched for i in (1, 6)], default=0)
    if need > cap:
        raise BufferOverflow(need)
    ov = np.zeros(n, dtype=bool)
    keys = ("cj", "ccl", "chits", "cminw", "ukeys") + (
        ("uj", "uu", "ped", "pfirst", "plast") if aligned else ())
    parts = {key: [] for key in keys}
    for (c0, nr, _), h in zip(chunks, fetched):
        ovc, ccount, cj, ccl, chits, cminw, ucount, uj, uu = h[:9]
        nc, nu = int(ccount), int(ucount)
        ov[c0:c0 + nr] = ovc[:nr]
        parts["cj"].append(cj[:nc] + c0)
        parts["ccl"].append(ccl[:nc])
        parts["chits"].append(chits[:nc])
        parts["cminw"].append(cminw[:nc])
        parts["ukeys"].append((uj[:nu] + c0) * tot_units + uu[:nu])
        if aligned:
            packed = h[9]
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


def _finisher(tabs: ScourTables, attr: str, C: int, dispatch, finish):
    """Dispatch at the tables' winner-buffer factor `attr` and return the
    closure that fetches the result. Buffers that overflow are a sticky
    escalation: this database and workload need bigger ones, so the
    closure redoes the dispatch once at factor 4, or at the power of two
    that holds the largest chunk where 4 does not, and the tables
    remember it for later batches."""
    factor = getattr(tabs, attr)
    chunks = dispatch(factor)

    def finisher():
        try:
            return finish(chunks, factor * C)
        except BufferOverflow as exc:
            grown = max(4, _pow2_ceil(-(-exc.need // C)))
            if grown <= factor:
                raise
            setattr(tabs, attr, max(getattr(tabs, attr), grown))
            return finish(dispatch(grown), grown * C)
    return finisher


def scour_rows(qmat: np.ndarray, lens: np.ndarray, k: int,
               mm_member: np.ndarray, mm_inner: np.ndarray,
               tabs: ScourTables, tot_units: int, E: int | None = None):
    """Scour `n` clear rows on the device, in fixed-size row chunks.

    Returns a finish() closure yielding a dict: `ov` [n] overflow flags,
    candidate tuples `cj`/`ccl`/`chits`/`cminw` (hits > mm_member,
    unordered) and passing unit keys `ukeys` (ascending)."""
    if E is None:
        E = slot_budget(tabs, int(lens.max(initial=k)) - k + 1)
    n = len(lens)
    C = chunk_rows(E)
    return _finisher(
        tabs, "cap_factor", C,
        lambda fac: _chunk_dispatch(qmat, lens, k, mm_member, mm_inner,
                                    tabs, tot_units, E, C, None, fac)[0],
        lambda chunks, cap: _chunk_finish(chunks, n, tot_units, cap, False))


def scour_bunch_rows(wmat: np.ndarray, wgt: np.ndarray,
                     nwords: np.ndarray, mm_bunch: np.ndarray,
                     mm_uinner: np.ndarray, tabs: ScourTables,
                     tot_units: int, E: int | None = None):
    """Scour `nB` bunch word-list rows on the device.

    wmat/wgt: [nB, T] word values / MAX-multiplicity weights, packed
    left; nwords: per-row word counts. Returns (like scour_rows) a
    finish() closure yielding `ov` [nB], candidate tuples `cj` (bunch
    row) / `ccl` / `chits` / `cminw`, and `ukeys` = bunch row * tot_units
    + unit for units whose weighted hits exceed mm_uinner."""
    dev = tabs.ids.device
    nB, T = wmat.shape
    if E is None:
        E = bunch_slot_budget(tabs, T)
    C = bunch_chunk_rows(E)
    npad = max(C, -(-nB // C) * C)

    def dispatch(fac):
        cap = fac * C
        wp = np.zeros((npad, max(T, 1)), dtype=np.int64)
        wp[:nB, :T] = wmat
        gp = np.ones((npad, max(T, 1)), dtype=np.int64)
        gp[:nB, :T] = wgt
        nwp = np.zeros(npad, dtype=np.int64)
        nwp[:nB] = nwords
        wp_d = torch.from_numpy(wp).to(dev)
        gp_d = torch.from_numpy(gp).to(dev)
        nw_d = torch.from_numpy(nwp).to(dev)
        mmm_d = _saturate(mm_bunch, npad, dev)
        mmi_d = _saturate(mm_uinner, npad, dev)
        return [(c0, min(C, max(0, nB - c0)), _scour_core_words(
            wp_d[c0:c0 + C], nw_d[c0:c0 + C], gp_d[c0:c0 + C], tabs,
            mmm_d[c0:c0 + C], mmi_d[c0:c0 + C], E, cap, cap))
            for c0 in range(0, npad, C)]

    return _finisher(
        tabs, "cap_factor_bunch", C, dispatch,
        lambda chunks, cap: _chunk_finish(chunks, nB, tot_units, cap,
                                          False))


def scour_align_rows(qmat: np.ndarray, lens: np.ndarray, k: int,
                     mm_member: np.ndarray, mm_inner: np.ndarray,
                     tabs: ScourTables, tot_units: int, smat_dev,
                     tiles_packed: torch.Tensor, W: int,
                     E: int | None = None):
    """Fused scour + phase-A pair scan for `n` clear rows.

    Like scour_rows, but the passing units also go through K1 on the
    device: the dict also holds their pairs `uj`/`uu` and the pairs'
    results `ped`/`pfirst`/`plast`. finish.batch_dev holds the uploaded
    (query matrix, lengths) for reuse."""
    if E is None:
        E = slot_budget(tabs, int(lens.max(initial=k)) - k + 1)
    n = len(lens)
    C = chunk_rows(E)
    ctx = (smat_dev, tiles_packed, W)
    batch_dev = []

    def dispatch(fac):
        chunks, qp_d, lp_d = _chunk_dispatch(
            qmat, lens, k, mm_member, mm_inner, tabs, tot_units, E, C,
            ctx, fac)
        batch_dev[:] = [qp_d, lp_d]
        return chunks

    finish = _finisher(
        tabs, "cap_factor", C, dispatch,
        lambda chunks, cap: _chunk_finish(chunks, n, tot_units, cap, True))
    finish.batch_dev = tuple(batch_dev)
    return finish
