"""Alignment engine, main-path slice: fused device scour + phase-A pair
scan, winner selection, phase-B rescore -> result pods.

Counterpart of the parts of `burst_tpu.engine` that BEST mode with an
accelerator runs at QBUNCH=1 (`accel_scan_fused` and what it reaches).
Host-side numpy logic is carried over unchanged so that the pods, and
so the b6 bytes, are identical; device work is PyTorch ops plus the
hand-written kernels K1 (fused scour), K2 (side pairs) and K3
(rescore). There is no fallback that hides the device: a step that the
slice does not cover raises NotImplementedError naming the ROADMAP item
that will bring it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from burst_tpu.process import QueryData, RefData

from . import devtime
from .kernels import scour_device
from .kernels.myers import build_peq_dev
from .kernels.myers_cuda import myers_pairs
from .kernels.rescore import rescore_finalize_host
from .kernels.rescore_cuda import rescore_pairs_gather

VECSZ = 16      # the reference's clump width; defines pod ordering only
QCHUNK = 2048   # canonical query-block height
MAX_W = 8       # Myers words per query the pair kernel takes


@dataclasses.dataclass
class Pods:
    """Columnar result pods (one row per surviving (query, unit) hit)."""
    six: np.ndarray        # base unique-query index
    juni: np.ndarray       # unibin row (fwd: six, rc: six + numUniq)
    refpos: np.ndarray     # position in sorted/dedup unit order ("refIx")
    ed: np.ndarray         # mismatches (total edit distance)
    rc: np.ndarray
    gap_q: np.ndarray
    gap_r: np.ndarray
    final_pos: np.ndarray
    score: np.ndarray      # float32 identity


@dataclasses.dataclass
class Visits:
    """CSR candidate clump visit lists per unibin (burst.c:4077-4136):
    flat[offs[j]:offs[j+1]] is unibin j's ordered visit list
    (pigeonhole-filtered candidates by hit count desc, first touch asc,
    then the BadList); pass_keys are the sorted j*tot_units+unit keys
    passing the per-unit prefilter."""
    flat: np.ndarray
    offs: np.ndarray
    pass_keys: np.ndarray


@dataclasses.dataclass
class SparseED:
    """Phase-A results over candidate pairs: unibin pj, unit pp, min ED
    pe (<= 255) and the first/last best columns (padded coordinates).
    `pending` holds deferred (part, [3, B] result) chunks until
    materialize() fetches them in one go."""
    pj: np.ndarray
    pp: np.ndarray
    pe: np.ndarray | None
    pending: list | None = None
    plast: np.ndarray | None = None
    pfirst: np.ndarray | None = None

    def materialize(self):
        if self.pending is not None:
            self.pe = np.full(len(self.pj), 255, dtype=np.int64)
            self.plast = np.full(len(self.pj), -1, dtype=np.int64)
            self.pfirst = np.full(len(self.pj), -1, dtype=np.int64)
            host = devtime.fetch([res for _, res in self.pending])
            for (part, _), h in zip(self.pending, host):
                self.pe[part] = h[0][: len(part)]
                self.pfirst[part] = h[1][: len(part)]
                self.plast[part] = h[2][: len(part)]
            np.minimum(self.pe, 255, out=self.pe)
            self.pending = None
        return self

    def lookup_cols(self, juni, refpos, tot_units: int):
        """(first, last) best columns per (unibin, unit) winner; -1 if
        unknown."""
        first = np.full(len(juni), -1, dtype=np.int64)
        last = np.full(len(juni), -1, dtype=np.int64)
        if self.plast is None or not len(self.pj):
            return first, last
        keys = self.pj * tot_units + self.pp
        so = np.argsort(keys)
        ks = keys[so]
        want = juni * tot_units + refpos
        loc = np.searchsorted(ks, want)
        np.minimum(loc, len(ks) - 1, out=loc)
        hit = ks[loc] == want
        last[hit] = self.plast[so][loc[hit]]
        first[hit] = self.pfirst[so][loc[hit]]
        return first, last


# ------------------------------------------------------------ host shapes

def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _query_matrix(qd: QueryData):
    """Cached [nj, 32*Wmax] padded query matrix + per-row lengths/W."""
    cache = getattr(qd, "_qmat", None)
    if cache is not None:
        return cache
    nj = len(qd.seqs)
    qlens = np.array([len(s) for s in qd.seqs], dtype=np.int64)
    wmax = max(1, int(-(-qlens.max() // 32))) if nj else 1
    qmat = np.zeros((nj, wmax * 32), dtype=np.uint8)
    for j, s in enumerate(qd.seqs):
        qmat[j, : len(s)] = s
    qw = np.maximum(1, -(-qlens // 32))
    cache = (qmat, qlens, qw)
    qd._qmat = cache
    return cache


def _unit_lb(rd: RefData, granularity: int = 64):
    """[tot_units] padded length bucket per sorted position (cached)."""
    lbs = getattr(rd, "_unit_lb", None)
    if lbs is None:
        ulen = rd.lens[rd.ix_srt[: rd.tot_units]]
        lbs = (-(-np.maximum(ulen, 1) // granularity) * granularity
               ).astype(np.int64)
        rd._unit_lb = lbs
    return lbs


def _fill_rows(mat: np.ndarray, rd: RefData, positions: np.ndarray):
    """Copy units (sorted positions) into the zero-padded row matrix
    through the shared native memcpy, in chunks."""
    from burst_tpu.native import pad_rows_native
    seqs, ix = rd.seqs, rd.ix_srt
    step = 1 << 20
    for c0 in range(0, len(positions), step):
        chunk = [seqs[ix[p]] for p in positions[c0:c0 + step]]
        lens = np.fromiter((len(s) for s in chunk), np.int64,
                           count=len(chunk))
        offs = np.zeros(len(chunk) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        cat = np.concatenate(chunk) if chunk else np.zeros(0, np.uint8)
        if not pad_rows_native(cat, offs, mat[c0:c0 + len(chunk)]):
            raise RuntimeError("burst_tpu native host library unavailable")


def _tile_matrix(rd: RefData, lb: int, pad: int):
    """Host [n, lb+pad] padded tile matrix of one length bucket, pow2
    rows, and its sorted-position -> row map."""
    positions = np.nonzero(_unit_lb(rd) == lb)[0]
    mat = np.zeros((_pow2_ceil(max(1, len(positions))), lb + pad),
                   dtype=np.uint8)
    _fill_rows(mat, rd, positions)
    pos2row = np.full(rd.tot_units, -1, dtype=np.int64)
    pos2row[positions] = np.arange(len(positions))
    return mat, pos2row


def _tiles_device_all(rd: RefData, device: torch.device, pad: int = 32):
    """Nibble-packed tile store over ALL units: row = sorted position,
    logical width = max length bucket + pad, 2 codes per byte (the
    reference's clump layout, burst.c:2810-2824). Returns (packed
    [pow2(tot_units), width/2] uint8 tensor, logical width)."""
    lbmax = int(_unit_lb(rd).max()) if rd.tot_units else 64
    width = -(-(lbmax + pad) // 2) * 2
    mat = np.zeros((_pow2_ceil(max(1, rd.tot_units)), width),
                   dtype=np.uint8)
    _fill_rows(mat, rd, np.arange(rd.tot_units, dtype=np.int64))
    packed = mat[:, 0::2] | (mat[:, 1::2] << 4)
    return torch.from_numpy(packed).to(device), width


def tile_budget_bytes(device: torch.device) -> int | None:
    """Bytes of resident tiles the device may hold: half the card's
    memory, the rest left to the scour's working set. None on the CPU
    (the plain path keeps everything in host memory)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1] // 2


def _check_budget(nbytes: int, device: torch.device, what: str):
    budget = tile_budget_bytes(device)
    if budget is not None and nbytes > budget:
        raise NotImplementedError(
            f"{what}: {nbytes} bytes over the {budget}-byte resident tile "
            "budget; databases larger than device memory need slabs "
            "(ROADMAP M9)")


def _peq_device(qd: QueryData, W: int, db):
    """(row2local, Peq [pow2 rows, 16, W] int32) for the unibin rows of
    Myers word count W, built on the device; cached on the batch."""
    cache = qd.__dict__.setdefault("_peq_torch", {})
    got = cache.get(W)
    if got is None:
        qmat, qlens, qw = _query_matrix(qd)
        rows = np.nonzero(qw == W)[0]
        n = _pow2_ceil(max(1, len(rows)))
        qm = np.zeros((n, 32 * W), dtype=np.uint8)
        qm[: len(rows)] = qmat[rows, : 32 * W]
        ql = np.zeros(n, dtype=np.int64)
        ql[: len(rows)] = qlens[rows]
        peq = build_peq_dev(torch.from_numpy(qm).to(db.device),
                            torch.from_numpy(ql).to(db.device),
                            db.smat_dev, W)
        # pad rows beyond the bucket are zeros, as the host build pads
        peq[len(rows):] = 0
        row2local = np.full(len(qd.seqs), -1, dtype=np.int64)
        row2local[rows] = np.arange(len(rows))
        got = cache[W] = (row2local, peq)
    return got


def _inject_device_peq(qd, b0: int, b1: int, W: int, db, fetch):
    """Seed the Peq cache from the fused scan's uploaded batch matrix
    when the scan covered every row and they share one word count."""
    nj = len(qd.seqs)
    if b0 != 0 or b1 != nj:
        return
    _, _, qw = _query_matrix(qd)
    if nj == 0 or not bool((qw == W).all()):
        return
    cache = qd.__dict__.setdefault("_peq_torch", {})
    if W in cache:
        return
    qp_d, lp_d = fetch.batch_dev
    peq = build_peq_dev(qp_d, lp_d, db.smat_dev, W)
    pow2 = max(_pow2_ceil(nj), peq.shape[0])
    if pow2 > peq.shape[0]:
        peq = torch.cat([peq, peq.new_zeros((pow2 - peq.shape[0], 16, W))])
    peq[nj:] = 0
    cache[W] = (np.arange(nj, dtype=np.int64), peq)


# ------------------------------------------------------------- phase A

def _pairs_min_ed(qd: QueryData, db, pj: np.ndarray, pp: np.ndarray):
    """Side-branch pairs (ambiguous rows, BadList units, host re-scoured
    rows) through K2, bucketed by (W, unit length bucket); returns the
    deferred [(part, [3, B] device result)] chunks."""
    n = len(pj)
    rd = db.rd
    _, _, qw_all = _query_matrix(qd)
    qws = qw_all[pj]
    lbs = _unit_lb(rd)[pp]
    order = np.arange(n)
    pending = []
    for W in np.unique(qws):
        for lb in np.unique(lbs[qws == W]):
            sel = order[(qws == W) & (lbs == lb)]
            pos2row, tiles_dev = db.bucket_tiles(int(lb), 32)
            row2local, peq_dev = _peq_device(qd, int(W), db)
            trows = pos2row[pp[sel]]
            prows = row2local[pj[sel]]
            pchunk = min(QCHUNK * 4, _pow2_ceil(len(sel)))
            for s0 in range(0, len(sel), pchunk):
                part = sel[s0:s0 + pchunk]
                pidx = np.zeros(pchunk, np.int32)
                tidx = np.zeros(pchunk, np.int32)
                pidx[: len(part)] = prows[s0:s0 + pchunk]
                tidx[: len(part)] = trows[s0:s0 + pchunk]
                pending.append((part, myers_pairs(
                    peq_dev, tiles_dev,
                    torch.from_numpy(pidx).to(db.device),
                    torch.from_numpy(tidx).to(db.device), int(W))))
    return pending


def select_pods(qd: QueryData, ed: SparseED):
    """BEST tie selection: per base query, the pairs at its minimum ED
    within budget; returns winner (juni, refpos, ed)."""
    ed.materialize()
    budgets = qd.ed
    pj, pp, pe = ed.pj, ed.pp, ed.pe.astype(np.int64)
    six = qd.six[pj]
    best = np.full(qd.num_uniq, 255, dtype=np.int64)
    np.minimum.at(best, six, pe)
    keep = (pe == best[six]) & (pe <= budgets[six])
    return pj[keep], pp[keep], pe[keep]


# ------------------------------------------------------------- phase B

def rescore_pad(lb: int, W: int) -> int:
    """Pad columns of the rescore's bucket tiles: lb + 32W rounded up to
    a multiple of 64, so the wildcard tail rows always find pads."""
    return -(-(lb + 32 * W) // 64) * 64 - lb


def rescore_winners(qd: QueryData, db, juni, refpos, eds,
                    pod_order: np.ndarray, win_cols) -> Pods:
    """Phase B through K3: exact (ed, gap_q, gap_r, final_pos, identity)
    for the winner pairs, in `pod_order`.

    Zero-ED winners with a known last-best column skip the DP (no gaps,
    identity 1.0, final_pos = that column minus the wildcard pad shift).
    Pairs whose tie span (`win_cols`: first/last best columns from phase
    A) fits a narrow window run the DP on a [Lw-1]-column slice starting
    at x0 instead of the whole tile -- exact, since every min-ED last-row
    column and every min-cost path reaching one lies inside it."""
    rd = db.rd
    n = len(juni)
    gap_q = np.zeros(n, np.int64)
    gap_r = np.zeros(n, np.int64)
    fpos = np.zeros(n, np.int64)
    score = np.zeros(n, np.float32)
    out_ed = np.array(eds, dtype=np.int64)
    bound = out_ed               # tie mode: rescore bound is the pair's ED

    pending = []
    order = np.arange(n)
    _, qlens_all, qw_all = _query_matrix(qd)
    qws = qw_all[juni] if n else np.zeros(0, np.int64)
    lbs = _unit_lb(rd)[refpos] if n else np.zeros(0, np.int64)
    todo = np.ones(n, dtype=bool)
    first_m = np.asarray(win_cols[0], dtype=np.int64)
    last_m = np.asarray(win_cols[1], dtype=np.int64)
    if n:
        skip = (out_ed == 0) & (last_m > 0)
        score[skip] = np.float32(1.0)
        fpos[skip] = last_m[skip] - (qws[skip] * 32 - qlens_all[juni[skip]])
        todo &= ~skip
    x0_all = np.full(n, -1, dtype=np.int64)
    span_all = np.zeros(n, dtype=np.int64)
    if n:
        known = (first_m > 0) & (last_m > 0)
        # x0 = real_first - qlen - bound - 1 in 0-based tile coords; the
        # (rows - qlen) pad shift cancels out of the margin
        x0c = np.maximum(first_m - qws * 32 - bound - 1, 0)
        x0_all[known] = x0c[known]
        span_all[known] = (last_m - first_m)[known]

    def _dispatch(sel, W, peq_dev, tiles_dev, prows, trows, x0s, Lw):
        pchunk = min(4 * QCHUNK, _pow2_ceil(len(sel)))
        for s0 in range(0, len(sel), pchunk):
            part = sel[s0:s0 + pchunk]
            m = len(part)
            pidx = np.zeros(pchunk, np.int64)
            tidx = np.zeros(pchunk, np.int64)
            pidx[:m] = prows[s0:s0 + pchunk]
            tidx[:m] = trows[s0:s0 + pchunk]
            qlens = np.full(pchunk, 2, np.int64)  # dummies stay valid
            qlens[:m] = qlens_all[juni[part]]
            bnd = np.zeros(pchunk, np.int64)
            bnd[:m] = bound[part]
            xc = None
            if x0s is not None:
                xc = np.zeros(pchunk, np.int64)
                xc[:m] = x0s[s0:s0 + pchunk]
            dev = rescore_pairs_gather(
                peq_dev, tiles_dev, pidx, tidx, qlens, bnd, int(W),
                x0=xc, Lw=Lw if xc is not None else None)
            pending.append((part, qlens, dev, xc))

    for W in np.unique(qws[todo]):
        for lb in np.unique(lbs[todo & (qws == W)]):
            grp = todo & (qws == W) & (lbs == lb)
            m_pad = int(W) * 32
            lp = int(lb) + rescore_pad(int(lb), int(W))
            pos2row, tiles_dev = db.bucket_tiles(int(lb), lp - int(lb))
            row2local, peq_dev = _peq_device(qd, int(W), db)
            # windowed subset: tie span + scan rows + budget must fit Lw
            qmax = int(qlens_all[juni[grp]].max())
            rows_g = min(m_pad, -(-qmax // 8) * 8)
            bmax = int(bound[grp].max())
            Lw = -(-(rows_g + bmax + 2) // 128) * 128
            L1_full = -(-(lp + 1) // 128) * 128
            fits = grp & (x0_all >= 0) & \
                (span_all <= Lw - 1 - rows_g - bound - 1)
            if Lw >= L1_full:
                fits &= False
            for sub, windowed in ((fits, True), (grp & ~fits, False)):
                sel = order[sub]
                if not len(sel):
                    continue
                _dispatch(sel, W, peq_dev, tiles_dev,
                          row2local[juni[sel]], pos2row[refpos[sel]],
                          x0_all[sel] if windowed else None, Lw)
    if pending:
        host = devtime.fetch([dev for _, _, dev, _ in pending])
        for (part, qlens, _, xc), h in zip(pending, host):
            e, gq, gr, fp, sc = rescore_finalize_host(
                h[0], h[1], h[2], h[3], qlens)
            m = len(part)
            gap_q[part] = gq[:m]
            gap_r[part] = gr[:m]
            fpos[part] = fp[:m] + (xc[:m] if xc is not None else 0)
            score[part] = sc[:m]
            out_ed[part] = e[:m]

    srt = pod_order
    return Pods(six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
                ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
                gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


# ------------------------------------------------------------ accel path

def _assemble_visits(qd, res, b1: int, bad_arr) -> Visits:
    """Visits CSR from a scour result tuple."""
    n = len(qd.seqs)
    nb = len(bad_arr)
    mflat, mcnt, ukeys = res

    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1: b1 + 1] = np.cumsum(mcnt + nb)
    offs[b1 + 1:] = offs[b1]
    out = np.empty(int(offs[b1]), dtype=np.int64)
    nm = len(mflat)
    if nm != int(mcnt.sum()):
        raise RuntimeError(
            f"scour result inconsistent: len(mflat)={nm} != "
            f"sum(mcnt)={int(mcnt.sum())}")
    if nm:
        csum = np.concatenate(([0], np.cumsum(mcnt)[:-1]))
        dst = np.repeat(offs[:b1], mcnt) + \
            (np.arange(nm) - np.repeat(csum, mcnt))
        out[dst] = mflat
    if nb:
        dstb = (offs[:b1, None] + mcnt[:, None] +
                np.arange(nb)[None, :]).ravel()
        out[dstb] = np.tile(bad_arr, b1)
    return Visits(flat=out, offs=offs, pass_keys=ukeys)


def _ambig_word_lists(qd, b0: int, k: int, z: int):
    """Ambiguous unibins' expanded unique words + multiplicities."""
    from burst_tpu.accel import query_words

    aq_off = np.zeros(b0 + 1, np.int64)
    aqw_parts, aqm_parts = [], []
    for j in range(b0):
        words = query_words(qd.seqs[j], k, z, ambiguous=True)
        if words.size:
            uw_, um_ = np.unique(words, return_counts=True)
            aqw_parts.append(uw_.astype(np.int64))
            aqm_parts.append(um_.astype(np.int64))
            aq_off[j + 1] = aq_off[j] + len(uw_)
        else:
            aq_off[j + 1] = aq_off[j]
    aqw = np.concatenate(aqw_parts) if aqw_parts \
        else np.zeros(0, np.int64)
    aqm = np.concatenate(aqm_parts) if aqm_parts \
        else np.zeros(0, np.int64)
    return aq_off, aqw, aqm


def _scour_device_rows(qd, db, b0, b1, k, mm_bunch, mm_inner, qmat,
                       qlens_all, aq_off, aqw, aqm, n_clumps, W):
    """Clear rows [b0, b1) through the fused device scour + K1, merged
    with a host scour of the ambiguous rows [0, b0). Returns the member
    candidates (mflat, per-row counts mcnt, passing unit keys ukeys) in
    the native scour's order, and the device-aligned pairs of the clear
    rows.

    Rows over the slot budget E (`ov`) are re-scoured exactly on the
    host by the native scour and spliced back -- part of the algorithm,
    not a fallback: the device slot matrix is fixed-width."""
    from burst_tpu.native import scour_native

    acc = db.acc
    tot_units = db.rd.tot_units
    nc = b1 - b0
    lens_c = qlens_all[b0:b1]
    mm_m = mm_bunch[b0:b1]             # qbunch == 1: bunch == member
    mm_i = mm_inner[b0:b1]
    fetch = scour_device.scour_align_rows(
        qmat[b0:b1], lens_c, k, mm_m, mm_i, db.tabs, tot_units,
        db.smat_dev, db.tiles_packed, W)
    _inject_device_peq(qd, b0, b1, W, db, fetch)
    # ambiguous rows on the host while the device runs
    z = np.zeros(0, np.int64)
    amb = (z, z, z, z, z, z)
    if b0 > 0:
        amb = scour_native(qmat, qlens_all, b0, b0, 1, k, aq_off, aqw,
                           aqm, acc.csr, n_clumps, mm_bunch[:b0],
                           mm_inner[:b0], u_csr=acc.u_csr,
                           tot_units=tot_units, vecsz=VECSZ)
    dev = fetch()
    ov = dev["ov"]
    lj = dev["cj"]                     # local (0-based) clear row
    lcl = dev["ccl"]
    chits = dev["chits"]
    cminw = dev["cminw"]
    if ov.any():
        rows = np.nonzero(ov)[0]
        sub = np.ascontiguousarray(qmat[b0 + rows])
        zb = np.zeros(1, np.int64)
        sbf, sbh, sbc, smf, smc, suk = scour_native(
            sub, lens_c[rows], 0, len(rows), 1, k,
            np.zeros(len(rows) + 1, np.int64), zb, zb, acc.csr, n_clumps,
            mm_m[rows], mm_i[rows], u_csr=acc.u_csr, tot_units=tot_units,
            vecsz=VECSZ)
        keep = ~ov[lj]
        lj, lcl, chits, cminw = (lj[keep], lcl[keep], chits[keep],
                                 cminw[keep])
        # re-scoured rows' candidates keep their native (hits desc,
        # touch asc) order: minw encodes the native rank
        sj = np.repeat(rows.astype(np.int64), sbc)
        srank = np.arange(len(sbf), dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(sbc)[:-1])), sbc)
        lj = np.concatenate([lj, sj])
        lcl = np.concatenate([lcl, sbf])
        chits = np.concatenate([chits, sbh])
        cminw = np.concatenate([cminw, -(1 << 40) + srank])
        suk_g = rows[suk // tot_units].astype(np.int64) * tot_units \
            + suk % tot_units
    # candidates per row: hits desc, first-touch (min word) asc, clump
    # asc -- the native walk's insertion order
    srt = np.lexsort((lcl, cminw, -chits, lj))
    lj, lcl, chits = lj[srt], lcl[srt], chits[srt]
    mkeep = chits > mm_i[lj]
    mcnt_c = np.bincount(lj[mkeep], minlength=nc).astype(np.int64)
    ukeys_c = dev["ukeys"] + np.int64(b0) * tot_units
    if ov.any():
        keepu = ~ov[dev["ukeys"] // tot_units]
        ukeys_c = np.sort(np.concatenate(
            [ukeys_c[keepu], suk_g + np.int64(b0) * tot_units]))
    _, _, _, amf, amc, auk = amb
    res = (np.concatenate([amf, lcl[mkeep]]), np.concatenate([amc, mcnt_c]),
           np.concatenate([auk, ukeys_c]))
    pairinfo = {
        "uj": dev["uj"] + b0,          # global unibin rows
        "uu": dev["uu"],
        "packed": np.stack([dev["ped"], dev["pfirst"], dev["plast"]]),
        "ov_rows": np.nonzero(ov)[0] + b0,
    }
    return res, pairinfo


def accel_scan_fused(qd: QueryData, db, qbins: np.ndarray):
    """Fused accelerator scan (QBUNCH=1): device scour + K1 over the
    clear rows in one dispatch chain; ambiguous rows, BadList units and
    rows the device overflowed go through K2. Returns (visits, sed,
    stats) with stats counting the overflowed rows and the pairs of each
    branch."""
    rd, acc = db.rd, db.acc
    if getattr(qd, "xalpha", False):
        raise NotImplementedError("xalpha queries (ROADMAP M7)")
    k = acc.k
    n = len(qd.seqs)
    b0, b1 = int(qbins[0]), int(qbins[1])
    if b1 < n:
        raise NotImplementedError(
            f"{n - b1} full-scan rows (super-ambiguous or ineligible "
            "reads) need the dense cross kernel (ROADMAP K4)")
    qmat, qlens_all, qw_all = _query_matrix(qd)
    if b1 <= b0 or not bool((qlens_all[b0:b1] >= k).any()):
        raise NotImplementedError(
            "a batch without clear rows of length >= k needs the "
            "two-step accelerated path (ROADMAP M7)")
    W = int(qw_all[:b1].max())
    if W > MAX_W:
        raise NotImplementedError(
            f"W={W}: reads over {32 * MAX_W} bp exceed the pair kernel")
    tot_units = rd.tot_units
    n_clumps = tot_units // VECSZ + (1 if tot_units % VECSZ else 0)
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    errs = qd.ed[qd.six[:b1]].astype(np.int64)
    kload = errs * k + k
    mm_bunch = np.where(kload < lns, lns - kload, 0)
    mm_inner = np.where(kload < lns, lns - kload, 1)
    aq_off, aqw, aqm = _ambig_word_lists(qd, b0, k, acc.z)
    res, pinfo = _scour_device_rows(
        qd, db, b0, b1, k, mm_bunch, mm_inner, qmat, qlens_all, aq_off,
        aqw, aqm, n_clumps, W)
    vis = _assemble_visits(qd, res, b1, bad_arr)

    # side pairs: ambiguous rows (every lane of their visit lists),
    # BadList units for clear rows, and pass-units of overflowed rows
    hp_j, hp_p = [], []
    if b0:
        nvis = vis.offs[1: b0 + 1] - vis.offs[:b0]
        qrep = np.repeat(np.arange(b0, dtype=np.int64), nvis)
        ps = (vis.flat[: vis.offs[b0], None] * VECSZ
              + np.arange(VECSZ)).ravel()
        pjj = np.repeat(qrep, VECSZ)
        m = ps < tot_units
        hp_j.append(pjj[m])
        hp_p.append(ps[m])
    if len(bad_arr):
        units_b = (bad_arr[:, None] * VECSZ + np.arange(VECSZ)).ravel()
        units_b = units_b[units_b < tot_units]
        rows_c = np.arange(b0, b1, dtype=np.int64)
        hp_j.append(np.repeat(rows_c, len(units_b)))
        hp_p.append(np.tile(units_b, len(rows_c)))
    if len(pinfo["ov_rows"]):
        rowk = vis.pass_keys // tot_units
        inov = np.isin(rowk, pinfo["ov_rows"])
        hp_j.append(rowk[inov])
        hp_p.append(vis.pass_keys[inov] % tot_units)
    pj_h = np.concatenate(hp_j) if hp_j else np.zeros(0, np.int64)
    pp_h = np.concatenate(hp_p) if hp_p else np.zeros(0, np.int64)
    pending = _pairs_min_ed(qd, db, pj_h, pp_h) if len(pj_h) else []

    pj = np.concatenate([pj_h, pinfo["uj"]])
    pp = np.concatenate([pp_h, pinfo["uu"]])
    nh = len(pj_h)
    if len(pinfo["uj"]):
        # device pairs enter as an already fetched chunk
        pending.append((np.arange(nh, nh + len(pinfo["uj"])),
                        pinfo["packed"]))
    sed = SparseED(pj=pj, pp=pp, pe=None, pending=pending)
    stats = {"ov_rows": len(pinfo["ov_rows"]), "side_pairs": nh,
             "dev_pairs": len(pinfo["uj"])}
    return vis, sed, stats


def accel_pod_order(qd: QueryData, rd: RefData, visits: Visits, juni,
                    refpos):
    """Order winner pods like the reference accel path's linked lists:
    per base query, forward-strand pods then reverse (fold at
    burst.c:4299-4312), each block in reverse insertion order (clump
    visit rank desc, lane desc)."""
    n = len(juni)
    nj = len(visits.offs) - 1
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    nvis = visits.offs[1:] - visits.offs[:-1]
    vq = np.repeat(np.arange(nj, dtype=np.int64), nvis)
    vrank = np.arange(len(visits.flat), dtype=np.int64) - visits.offs[vq]
    vkey = vq * n_clumps + visits.flat
    so = np.argsort(vkey)
    vkey_s, vrank_s = vkey[so], vrank[so]
    clump = refpos // VECSZ
    rank = np.empty(n, dtype=np.int64)
    if n:
        rank[:] = vrank_s[np.searchsorted(vkey_s, juni * n_clumps + clump)]
    lane = refpos % VECSZ
    is_rc = qd.rc[juni].astype(np.int64)
    return np.lexsort((-lane, -rank, is_rc, qd.six[juni]))

