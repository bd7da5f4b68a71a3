"""Reporting modes: blast6 emission with the reference's exact semantics.

Counterpart of `burst_tpu.modes`, with `Pods`, `VECSZ` and
`rescore_winners` taken from this package's engine; the ANY reporters
take the device database (`state.DeviceDB`) where the original takes
the host `RefData`, since the rescore runs against its resident tiles.

Mirrors burst.c:4523-4892 (ALLPATHS, FORAGE, CAPITALIST
with LCA interpolation, BEST) and the inline ANY printer (:4457-4475).
All row ordering, dupe-suppression windows, tie rules, coordinate
arithmetic (including uint32 wraparound printed as %d), and float
formatting reproduce the reference byte-for-byte in single-thread
full-path order.
"""
from __future__ import annotations

import numpy as np

from .engine import Pods, VECSZ
from .process import QueryData, RefData

# Intra-taxonomic identity cutoffs (burst.c:264-266)
TAXLEVELS_STRICT = [.65, .75, .78, .82, .86, .94, .98, .995]
TAXLEVELS_LENIENT = [.55, .70, .75, .80, .84, .93, .97, .985]


def _u32(v: int) -> int:
    return int(v) & 0xFFFFFFFF


def _i32(v: int) -> int:
    v = _u32(v)
    return v - (1 << 32) if v >= (1 << 31) else v


def _fmt_score(score_f32: np.float32) -> str:
    # reference: float score * int 100 -> float multiply, then %f (double)
    v = np.float32(score_f32) * np.float32(100)
    return "%f" % float(v)


class B6Writer:
    def __init__(self, fh):
        self.fh = fh

    def row(self, qhead: bytes, rhead: bytes, score, al_len, num_mis,
            num_gap, qlen, st_ix, ed_ix, mism, last, tax: bytes | None):
        cols = [qhead.decode("latin-1"), rhead.decode("latin-1"),
                _fmt_score(score), str(_u32(al_len)), str(_u32(num_mis)),
                str(_u32(num_gap)), "1", str(_u32(qlen)),
                str(_i32(st_ix)), str(_u32(ed_ix)), str(_u32(mism)),
                str(last)]
        if tax is not None:
            cols.append(tax.decode("latin-1"))
        self.fh.write("\t".join(cols) + "\n")

    def write_bytes(self, data: bytes):
        self.fh.write(data.decode("latin-1"))


def _blob_cache(obj, attr: str, items):
    """Concatenated (blob, offsets) of a list of byte strings, cached."""
    got = getattr(obj, attr, None)
    if got is None:
        off = np.zeros(len(items) + 1, dtype=np.int64)
        for i, b in enumerate(items):
            off[i + 1] = off[i] + len(b)
        got = (b"".join(items), off)
        setattr(obj, attr, got)
    return got


def _coords(rc: bool, final_pos: int, qlen: int, gap_r: int, m_off: int):
    st = final_pos - qlen + gap_r + m_off
    edx = final_pos + m_off
    if rc:
        st, edx = edx, st
    return st, edx


def _m_off(rd: RefData, rix: int) -> int:
    return int(rd.start[rix]) if rd.start is not None else 0


def _expand_refs(rd: RefData, refpos: int):
    """Expand a pod's sorted position into original unit indices.

    With deduplicated references every group member is reported
    (burst.c:4602-4616); otherwise just the sorted unit itself.
    """
    if rd.dedup_ix is not None:
        a, b = int(rd.dedup_ix[refpos]), int(rd.dedup_ix[refpos + 1])
        return [int(rd.tmp_rix[k]) for k in range(a, b)]
    return [int(rd.ix_srt[refpos])]


class _DupeHunt:
    """(mapped ref, start +/- qlen/2) duplicate suppression
    (burst.c:4563-4570)."""

    def __init__(self):
        self.refs: list[int] = []
        self.starts: list[int] = []

    def seen(self, mapped: int, st_ix: int, ql2: int) -> bool:
        st_ix = _u32(st_ix)
        for r, s in zip(self.refs, self.starts):
            if r == mapped and _u32(s + ql2) > st_ix and s < _u32(st_ix + ql2):
                return True
        self.refs.append(mapped)
        self.starts.append(st_ix)
        return False


def _dupe_start(rc: bool, final_pos: int, qlen: int, gap_r: int,
                m_off: int) -> int:
    # DUPE_HUNT uses rc ? finalPos + mOff : finalPos - qlen + gapR + mOff
    return _u32(final_pos + m_off if rc
                else final_pos - qlen + gap_r + m_off)


def _pods_by_query(pods: Pods, num_uniq: int):
    by_q: list[list[int]] = [[] for _ in range(num_uniq)]
    for ix in range(len(pods.six)):
        by_q[int(pods.six[ix])].append(ix)
    return by_q


def _report_apf_native(pods, qd, rd, writer, taxonomy,
                       forage: bool) -> bool:
    """Columnar ALLPATHS/FORAGE emission (burst.c:4582-4692 row
    semantics) through the native dupe filter + b6 formatter; False ->
    the Python loop runs."""
    from .native import b6_format_native, dupe_filter_native, load_host
    if load_host() is None:
        return False
    n = len(pods.six)
    if n == 0:
        return True
    six = pods.six.astype(np.int64)
    nu = qd.num_uniq
    # stable group-by query, preserving pod order within each query
    order = np.argsort(six, kind="stable")
    osix = six[order]
    keep = np.ones(n, dtype=bool)
    if not forage:
        bm = np.full(nu, 1 << 30, np.int64)
        np.minimum.at(bm, six, pods.ed.astype(np.int64))
        keep = pods.ed[order] == bm[osix]
        # head-pod guard (burst.c:4598): drop queries whose first
        # best-ED pod has zero score
        kidx = np.nonzero(keep)[0]
        if len(kidx):
            first = kidx[np.unique(osix[kidx], return_index=True)[1]]
            bad_q = osix[first][pods.score[order[first]] == 0]
            keep &= ~np.isin(osix, bad_q)
    sel = order[keep]                      # pod rows, query-grouped
    if not len(sel):
        return True
    # expand dedup groups into per-(pod, unit) entries
    refpos = pods.refpos[sel].astype(np.int64)
    if rd.dedup_ix is not None:
        ga = rd.dedup_ix[refpos].astype(np.int64)
        gb = rd.dedup_ix[refpos + 1].astype(np.int64)
        gcnt = gb - ga
        tot = int(gcnt.sum())
        erow = np.repeat(np.arange(len(sel)), gcnt)   # entry -> sel row
        csum = np.concatenate(([0], np.cumsum(gcnt)[:-1]))
        rix = rd.tmp_rix[np.repeat(ga, gcnt) +
                         (np.arange(tot) - np.repeat(csum, gcnt))
                         ].astype(np.int64)
    else:
        erow = np.arange(len(sel))
        rix = rd.ix_srt[refpos].astype(np.int64)
    e_six = six[sel][erow]
    qlen_e = qd.lens[e_six].astype(np.int64)
    gr_e = pods.gap_r[sel][erow].astype(np.int64)
    fp_e = pods.final_pos[sel][erow].astype(np.int64)
    rc_e = pods.rc[sel][erow].astype(bool)
    mo = rd.start[rix].astype(np.int64) if rd.start is not None \
        else np.zeros(len(rix), np.int64)
    st_dupe = np.where(rc_e, fp_e + mo, fp_e - qlen_e + gr_e + mo) \
        & 0xFFFFFFFF
    # per-query entry group offsets for the sequential dupe filter
    qcnt = np.bincount(e_six, minlength=nu)
    used_q = np.nonzero(qcnt)[0]
    offs = np.concatenate(([0], np.cumsum(qcnt[used_q])))
    kmask = dupe_filter_native(offs, rd.ref_map[rix].astype(np.int64),
                               st_dupe.astype(np.uint32),
                               (qd.lens[used_q].astype(np.int64) >> 1))
    if kmask is None:
        return False
    erow, rix = erow[kmask], rix[kmask]
    e_six, qlen_e = e_six[kmask], qlen_e[kmask]
    gr_e, fp_e, rc_e, mo = (gr_e[kmask], fp_e[kmask], rc_e[kmask],
                            mo[kmask])
    gq_e = pods.gap_q[sel][erow].astype(np.int64)
    ed_e = pods.ed[sel][erow].astype(np.int64)
    sc_e = pods.score[sel][erow].astype(np.float32)
    num_gap = gq_e + gr_e
    st = np.where(rc_e, fp_e + mo, fp_e - qlen_e + gr_e + mo)
    edx = np.where(rc_e, fp_e - qlen_e + gr_e + mo, fp_e + mo)
    tax_items = trow_e = None
    if taxonomy:
        urix, inv = np.unique(rix, return_inverse=True)
        tax_items = [taxonomy.lookup(rd.heads[int(r)]) for r in urix]
        trow_e = inv.astype(np.int64)
    # duplicate-query expansion: rows = per query, j outer x entry inner
    ecnt = np.bincount(e_six, minlength=nu)
    eoff = np.concatenate(([0], np.cumsum(ecnt)))
    dup = (qd.offset[1:] - qd.offset[:-1]).astype(np.int64)
    blocks_q = np.repeat(np.arange(nu), np.where(ecnt > 0, dup, 0))
    jrel = (np.arange(len(blocks_q)) -
            np.concatenate(([0], np.cumsum(np.where(ecnt > 0, dup, 0))
                            ))[blocks_q])
    bcnt = ecnt[blocks_q]
    nrows = int(bcnt.sum())
    if nrows == 0:
        return True
    bid = np.repeat(np.arange(len(blocks_q)), bcnt)
    bstart = np.concatenate(([0], np.cumsum(bcnt)[:-1]))
    eix = eoff[blocks_q[bid]] + (np.arange(nrows) - bstart[bid])
    qrow = (qd.offset[blocks_q] + jrel)[bid].astype(np.int64)
    qblob, qoff = _blob_cache(qd, "_hblob", qd.heads_sorted)
    rblob, roff = _blob_cache(rd, "_hblob", rd.heads)
    targs = {}
    if tax_items is not None:
        toff = np.zeros(len(tax_items) + 1, np.int64)
        for i2, b in enumerate(tax_items):
            toff[i2 + 1] = toff[i2] + len(b)
        targs = dict(tblob=b"".join(tax_items), toff=toff,
                     trow=trow_e[eix])
    out = b6_format_native(
        qblob, qoff, qrow, rblob, roff, rix[eix],
        sc_e[eix],
        ((qlen_e + num_gap)[eix] & 0xFFFFFFFF).astype(np.uint32),
        ((ed_e - num_gap)[eix] & 0xFFFFFFFF).astype(np.uint32),
        (num_gap[eix] & 0xFFFFFFFF).astype(np.uint32),
        (qlen_e[eix] & 0xFFFFFFFF).astype(np.uint32),
        (st[eix] & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        (edx[eix] & 0xFFFFFFFF).astype(np.uint32),
        (ed_e[eix] & 0xFFFFFFFF).astype(np.uint32),
        e_six[eix], **targs)
    if out is None:
        return False
    writer.write_bytes(out)
    return True


def report_allpaths_or_forage(pods: Pods, qd: QueryData, rd: RefData,
                              writer: B6Writer, taxonomy=None,
                              forage: bool = False):
    if _report_apf_native(pods, qd, rd, writer, taxonomy, forage):
        return
    by_q = _pods_by_query(pods, qd.num_uniq)
    for i in range(qd.num_uniq):
        lst = by_q[i]
        if not lst:
            continue
        qlen = int(qd.lens[i])
        ql2 = qlen >> 1
        if not forage:
            bm = min(int(pods.ed[ix]) for ix in lst)
            lst = [ix for ix in lst if int(pods.ed[ix]) == bm]
            # reference also requires rp->score nonzero for ALLPATHS
            # (burst.c:4598): guard the whole emission on the head pod
            if pods.score[lst[0]] == 0:
                continue
        hunt = _DupeHunt()
        emit: list[tuple[int, int]] = []       # (pod ix, rix)
        for ix in lst:
            for rix in _expand_refs(rd, int(pods.refpos[ix])):
                mo = _m_off(rd, rix)
                st = _dupe_start(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                                 qlen, int(pods.gap_r[ix]), mo)
                if hunt.seen(int(rd.ref_map[rix]), st, ql2):
                    continue
                emit.append((ix, rix))
        for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
            for ix, rix in emit:
                mo = _m_off(rd, rix)
                gq, gr = int(pods.gap_q[ix]), int(pods.gap_r[ix])
                num_gap = gq + gr
                st = _u32(pods.final_pos[ix] + mo) if pods.rc[ix] else \
                    _u32(pods.final_pos[ix] - qlen + gr + mo)
                edx = _u32(pods.final_pos[ix] - qlen + gr + mo) \
                    if pods.rc[ix] else _u32(pods.final_pos[ix] + mo)
                tax = taxonomy.lookup(rd.heads[rix]) if taxonomy else None
                writer.row(qd.heads_sorted[j], rd.heads[rix], pods.score[ix],
                           qlen + num_gap, int(pods.ed[ix]) - num_gap,
                           num_gap, qlen, st, edx, int(pods.ed[ix]), i, tax)


def _suppress_best(tax: bytes, score: float, taxlevels) -> bytes:
    """Identity-based taxonomy suppression, BEST variant
    (burst.c:4874-4885). lm >= 8 (perfect scores) leaves the taxon whole;
    the reference reads past its 8-entry table there, but real taxonomies
    have <= 8 levels so no truncation occurs either way."""
    lm = 0
    while lm < 8 and taxlevels[lm] < score:
        lm += 1
    if lm == 0:
        return b""
    if lm >= 8:
        return tax
    parts = tax.split(b";")
    if len(parts) <= lm:
        return tax
    return b";".join(parts[:lm])


def _report_best_native(pods, qd, rd, writer, taxonomy, taxasuppress,
                        taxlv, order, firsts, rix_all) -> bool:
    """Columnar BEST emission through the native b6 formatter
    (burst.c:4847-4891 row semantics); False -> Python loop runs."""
    from .native import b6_format_native, load_host
    if load_host() is None:
        return False
    wins = order[firsts]
    i_arr = pods.six[wins].astype(np.int64)
    rix = rix_all[wins].astype(np.int64)
    qlen = qd.lens[i_arr].astype(np.int64)
    gq = pods.gap_q[wins].astype(np.int64)
    gr = pods.gap_r[wins].astype(np.int64)
    ed = pods.ed[wins].astype(np.int64)
    fp = pods.final_pos[wins].astype(np.int64)
    rc = pods.rc[wins].astype(bool)
    mo = rd.start[rix].astype(np.int64) if rd.start is not None \
        else np.zeros(len(wins), np.int64)
    st = fp - qlen + gr + mo
    edx = fp + mo
    st2 = np.where(rc, edx, st)
    ed2 = np.where(rc, st, edx)
    num_gap = gq + gr
    tax_items = None
    if taxonomy:
        tax_items = []
        for w in range(len(wins)):
            t = taxonomy.lookup(rd.heads[int(rix[w])])
            if taxasuppress:
                t = _suppress_best(t, float(pods.score[wins[w]]), taxlv)
            tax_items.append(t)
    # expand winners over their duplicate query rows
    cnt = (qd.offset[i_arr + 1] - qd.offset[i_arr]).astype(np.int64)
    nrows = int(cnt.sum())
    if nrows == 0:
        return True
    widx = np.repeat(np.arange(len(wins)), cnt)
    csum = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    qrow = (np.arange(nrows) - csum[widx] +
            qd.offset[i_arr][widx]).astype(np.int64)
    qblob, qoff = _blob_cache(qd, "_hblob", qd.heads_sorted)
    rblob, roff = _blob_cache(rd, "_hblob", rd.heads)
    targs = {}
    if tax_items is not None:
        toff = np.zeros(len(tax_items) + 1, np.int64)
        for i, b in enumerate(tax_items):
            toff[i + 1] = toff[i] + len(b)
        targs = dict(tblob=b"".join(tax_items), toff=toff,
                     trow=widx.astype(np.int64))
    out = b6_format_native(
        qblob, qoff, qrow, rblob, roff, rix[widx],
        pods.score[wins][widx].astype(np.float32),
        ((qlen + num_gap)[widx] & 0xFFFFFFFF).astype(np.uint32),
        ((ed - num_gap)[widx] & 0xFFFFFFFF).astype(np.uint32),
        (num_gap[widx] & 0xFFFFFFFF).astype(np.uint32),
        (qlen[widx] & 0xFFFFFFFF).astype(np.uint32),
        (st2[widx] & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        (ed2[widx] & 0xFFFFFFFF).astype(np.uint32),
        (ed[widx] & 0xFFFFFFFF).astype(np.uint32),
        i_arr[widx].astype(np.int64), **targs)
    if out is None:
        return False
    writer.write_bytes(out)
    return True


def report_best(pods: Pods, qd: QueryData, rd: RefData, writer: B6Writer,
                taxonomy=None, taxasuppress=False, strict=False):
    taxlv = TAXLEVELS_STRICT if strict else TAXLEVELS_LENIENT
    n = len(pods.six)
    if n == 0:
        return
    # winner per query = lexicographic min by (ed, -score, original ref
    # index); unique keys, so equivalent to the reference's
    # strict-improvement scan (burst.c:4854-4860)
    rix_all = rd.ix_srt[pods.refpos]
    order = np.lexsort((rix_all, -pods.score, pods.ed, pods.six))
    six_sorted = pods.six[order]
    firsts = np.unique(six_sorted, return_index=True)[1]
    if _report_best_native(pods, qd, rd, writer, taxonomy, taxasuppress,
                           taxlv, order, firsts, rix_all):
        return
    for w in firsts:
        ix = int(order[w])
        i = int(pods.six[ix])
        rix = int(rix_all[ix])
        qlen = int(qd.lens[i])
        gq, gr = int(pods.gap_q[ix]), int(pods.gap_r[ix])
        num_gap = gq + gr
        mo = _m_off(rd, rix)
        st, edx = _coords(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                          qlen, gr, mo)
        tax = None
        if taxonomy:
            tax = taxonomy.lookup(rd.heads[rix])
            if taxasuppress:
                tax = _suppress_best(tax, float(pods.score[ix]), taxlv)
        for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
            writer.row(qd.heads_sorted[j], rd.heads[rix], pods.score[ix],
                       qlen + num_gap, int(pods.ed[ix]) - num_gap, num_gap,
                       qlen, st, edx, int(pods.ed[ix]), i, tax)


def _report_capitalist_native(pods, qd, rd, writer, taxonomy, taxacut,
                              taxasuppress, taxlv) -> bool:
    """Columnar CAPITALIST (burst.c:4694-4846): vectorized expansion +
    native dupe filter and winner walk. Assumes every pod of a query
    ties at its best ED (what select_pods produces for this mode);
    False -> the Python loop runs."""
    from .native import (b6_format_native, capitalist_select_native,
                         dupe_filter_native, load_host)
    if load_host() is None:
        return False
    n = len(pods.six)
    if n == 0:
        return True
    six = pods.six.astype(np.int64)
    nu = qd.num_uniq
    # verify the equal-ED assumption cheaply
    mn = np.full(nu, 1 << 30, np.int64)
    mx = np.full(nu, -1, np.int64)
    np.minimum.at(mn, six, pods.ed.astype(np.int64))
    np.maximum.at(mx, six, pods.ed.astype(np.int64))
    used = mx >= 0
    if not np.array_equal(mn[used], mx[used]):
        return False
    order = np.argsort(six, kind="stable")
    sel = order
    refpos = pods.refpos[sel].astype(np.int64)
    if rd.dedup_ix is not None:
        ga = rd.dedup_ix[refpos].astype(np.int64)
        gb = rd.dedup_ix[refpos + 1].astype(np.int64)
        gcnt = gb - ga
        tot = int(gcnt.sum())
        erow = np.repeat(np.arange(len(sel)), gcnt)
        csum = np.concatenate(([0], np.cumsum(gcnt)[:-1]))
        rix = rd.tmp_rix[np.repeat(ga, gcnt) +
                         (np.arange(tot) - np.repeat(csum, gcnt))
                         ].astype(np.int64)
    else:
        erow = np.arange(len(sel))
        rix = rd.ix_srt[refpos].astype(np.int64)
    e_six = six[sel][erow]
    qlen_e = qd.lens[e_six].astype(np.int64)
    gr_e = pods.gap_r[sel][erow].astype(np.int64)
    fp_e = pods.final_pos[sel][erow].astype(np.int64)
    rc_e = pods.rc[sel][erow].astype(bool)
    mo = rd.start[rix].astype(np.int64) if rd.start is not None \
        else np.zeros(len(rix), np.int64)
    st_dupe = np.where(rc_e, fp_e + mo, fp_e - qlen_e + gr_e + mo) \
        & 0xFFFFFFFF
    mapped = rd.ref_map[rix].astype(np.int64)
    qcnt = np.bincount(e_six, minlength=nu)
    used_q = np.nonzero(qcnt)[0]
    offs = np.concatenate(([0], np.cumsum(qcnt[used_q])))
    kmask = dupe_filter_native(offs, mapped,
                               st_dupe.astype(np.uint32),
                               (qd.lens[used_q].astype(np.int64) >> 1))
    if kmask is None:
        return False
    # pass 1-2: vote tally over kept entries
    n_bins = int(rd.ref_map.max()) + 1 if len(rd.ref_map) else 1
    counts = np.bincount(mapped[kmask], minlength=n_bins)
    # pass 3: winner walk per query over the kept entries
    erow_k, rix_k = erow[kmask], rix[kmask]
    e_six_k, mapped_k = e_six[kmask], mapped[kmask]
    kcnt = np.bincount(e_six_k, minlength=nu)
    used_k = np.nonzero(kcnt)[0]
    koffs = np.concatenate(([0], np.cumsum(kcnt[used_k])))
    bent = capitalist_select_native(koffs, sel[erow_k], mapped_k, counts)
    if bent is None:
        return False
    win_e = bent                               # entry per used_k query
    wins = sel[erow_k][win_e]                  # winning pod row
    wrix = rix_k[win_e]
    i_arr = used_k.astype(np.int64)
    qlen = qd.lens[i_arr].astype(np.int64)
    gq = pods.gap_q[wins].astype(np.int64)
    gr = pods.gap_r[wins].astype(np.int64)
    ed = pods.ed[wins].astype(np.int64)
    fp = pods.final_pos[wins].astype(np.int64)
    rc = pods.rc[wins].astype(bool)
    mo_w = rd.start[wrix].astype(np.int64) if rd.start is not None \
        else np.zeros(len(wrix), np.int64)
    st = np.where(rc, fp + mo_w, fp - qlen + gr + mo_w)
    edx = np.where(rc, fp - qlen + gr + mo_w, fp + mo_w)
    num_gap = gq + gr
    tax_items = None
    if taxonomy:
        tax_items = []
        scores_k = pods.score[sel][erow_k]
        for w, i in enumerate(used_k):
            lo, hi = int(koffs[w]), int(koffs[w + 1])
            taxa = [taxonomy.lookup(rd.heads[int(r)])
                    for r in rix_k[lo:hi]]
            best_score = float(scores_k[lo:hi].max())
            tax, lv = _lca(taxa, taxacut)
            if taxasuppress:
                lm = 0
                while lm < lv and lm < 8 and taxlv[lm] < best_score:
                    lm += 1
                if lm == 0:
                    tax = b""
                elif lm < lv and lm < 8:
                    parts = tax.split(b";")
                    if len(parts) > lm:
                        tax = b";".join(parts[:lm])
            tax_items.append(tax)
    cnt = (qd.offset[i_arr + 1] - qd.offset[i_arr]).astype(np.int64)
    nrows = int(cnt.sum())
    if nrows == 0:
        return True
    widx = np.repeat(np.arange(len(i_arr)), cnt)
    csum2 = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    qrow = (np.arange(nrows) - csum2[widx] +
            qd.offset[i_arr][widx]).astype(np.int64)
    qblob, qoff = _blob_cache(qd, "_hblob", qd.heads_sorted)
    rblob, roff = _blob_cache(rd, "_hblob", rd.heads)
    targs = {}
    if tax_items is not None:
        toff = np.zeros(len(tax_items) + 1, np.int64)
        for i2, b in enumerate(tax_items):
            toff[i2 + 1] = toff[i2] + len(b)
        targs = dict(tblob=b"".join(tax_items), toff=toff, trow=widx)
    out = b6_format_native(
        qblob, qoff, qrow, rblob, roff, wrix[widx],
        pods.score[wins][widx].astype(np.float32),
        ((qlen + num_gap)[widx] & 0xFFFFFFFF).astype(np.uint32),
        ((ed - num_gap)[widx] & 0xFFFFFFFF).astype(np.uint32),
        (num_gap[widx] & 0xFFFFFFFF).astype(np.uint32),
        (qlen[widx] & 0xFFFFFFFF).astype(np.uint32),
        (st[widx] & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        (edx[widx] & 0xFFFFFFFF).astype(np.uint32),
        (ed[widx] & 0xFFFFFFFF).astype(np.uint32),
        i_arr[widx], **targs)
    if out is None:
        return False
    writer.write_bytes(out)
    return True


def report_capitalist(pods: Pods, qd: QueryData, rd: RefData,
                      writer: B6Writer, taxonomy=None, taxacut: int = 10,
                      taxasuppress=False, strict=False):
    taxlv0 = TAXLEVELS_STRICT if strict else TAXLEVELS_LENIENT
    if _report_capitalist_native(pods, qd, rd, writer, taxonomy,
                                 taxacut, taxasuppress, taxlv0):
        return
    by_q = _pods_by_query(pods, qd.num_uniq)
    taxlv = TAXLEVELS_STRICT if strict else TAXLEVELS_LENIENT
    n_bins = int(rd.ref_map.max()) + 1 if len(rd.ref_map) else 1
    counts = np.zeros(n_bins, dtype=np.int64)

    # Pass 1-2: tally votes over best-ED pods with dupe suppression
    for i in range(qd.num_uniq):
        lst = by_q[i]
        if not lst:
            continue
        bm = min(int(pods.ed[ix]) for ix in lst)
        qlen = int(qd.lens[i])
        ql2 = qlen >> 1
        hunt = _DupeHunt()
        for ix in lst:
            if int(pods.ed[ix]) != bm:
                continue
            for rix in _expand_refs(rd, int(pods.refpos[ix])):
                mo = _m_off(rd, rix)
                st = _dupe_start(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                                 qlen, int(pods.gap_r[ix]), mo)
                if hunt.seen(int(rd.ref_map[rix]), st, ql2):
                    continue
                counts[int(rd.ref_map[rix])] += 1

    # Pass 3: per query pick max-vote ref among ties, interpolate taxonomy
    for i in range(qd.num_uniq):
        lst = by_q[i]
        if not lst:
            continue
        qlen = int(qd.lens[i])
        ql2 = qlen >> 1
        head_ed = int(pods.ed[lst[0]])
        hunt = _DupeHunt()
        best_ix = None
        best_map = best_rix = -1
        taxa: list[bytes] = []
        best_score = np.float32(-1.0)
        for ix in lst:
            if int(pods.ed[ix]) > head_ed:
                continue
            for rix in _expand_refs(rd, int(pods.refpos[ix])):
                mo = _m_off(rd, rix)
                st = _dupe_start(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                                 qlen, int(pods.gap_r[ix]), mo)
                mapped = int(rd.ref_map[rix])
                if hunt.seen(mapped, st, ql2):
                    continue
                if taxonomy:
                    taxa.append(taxonomy.lookup(rd.heads[rix]))
                    if pods.score[ix] > best_score:
                        best_score = pods.score[ix]
                if (best_ix is None or ix == best_ix or
                        counts[mapped] > counts[best_map] or
                        (counts[mapped] == counts[best_map] and
                         mapped < best_map)):
                    best_ix, best_map, best_rix = ix, mapped, rix
        if best_ix is None:
            continue
        tax = None
        if taxonomy:
            tax, lv = _lca(taxa, taxacut)
            if taxasuppress:
                # burst.c:4820-4828: lm bounded by the LCA level lv (which
                # the shortcut paths leave "infinite"); lm >= 8 behaves as
                # no suppression (see _suppress_best note)
                lm = 0
                while lm < lv and lm < 8 and taxlv[lm] < float(best_score):
                    lm += 1
                if lm == 0:
                    tax = b""
                elif lm < lv and lm < 8:
                    parts = tax.split(b";")
                    if len(parts) > lm:
                        tax = b";".join(parts[:lm])
        ix = best_ix
        rix = best_rix
        gq, gr = int(pods.gap_q[ix]), int(pods.gap_r[ix])
        num_gap = gq + gr
        mo = _m_off(rd, rix)
        st, edx = _coords(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                          qlen, gr, mo)
        for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
            writer.row(qd.heads_sorted[j], rd.heads[rix], pods.score[ix],
                       qlen + num_gap, int(pods.ed[ix]) - num_gap, num_gap,
                       qlen, st, edx, int(pods.ed[ix]), i, tax)


def _lca(taxa: list[bytes], taxacut: int):
    """LCA with TAXACUT discord tolerance (burst.c:4781-4818).

    Returns (taxon, lv) where lv is the kept level count; the shortcut
    paths (single taxon / zero agreement) return lv = 2**30, matching the
    reference's uninitialized lv = (uint32_t)-1.
    """
    tix = len(taxa)
    if tix == 1:
        return taxa[0], 1 << 30
    taxa = sorted(taxa)
    div = [0] * tix
    maxdiv = 0
    for z in range(1, tix):
        a, b = taxa[z - 1], taxa[z]
        d = 0
        x = 0
        ml = min(len(a), len(b))
        while x < ml and a[x] == b[x]:
            if a[x] == 0x3B:  # ';'
                d += 1
            x += 1
        if x == len(a):
            d += 1  # reference counts full-prefix strings as one deeper
        div[z] = d
        maxdiv = max(maxdiv, d)
    if maxdiv == 0:
        return b"", 1 << 30
    cutoff = tix - tix // taxacut
    st, ed = 0, tix
    lv = 1
    while lv <= maxdiv:
        accum = 1
        z = st + 1
        while z < ed:
            if div[z] >= lv:
                accum += 1
            elif accum >= cutoff:
                ed = z
                break
            else:
                accum = 1
                st = z
            z += 1
        if accum < cutoff:
            break
        cutoff = accum - accum // taxacut
        lv += 1
    if ed:
        ed -= 1
    lv -= 1
    # copy taxa[ed] up to (but excluding) the lv-th semicolon
    s = 0
    out = bytearray()
    t = taxa[ed]
    for ch in t:
        if ch == 0x3B:
            s += 1
            if s >= lv:
                break
        out.append(ch)
    if lv <= 0:
        out = bytearray()
    return bytes(out), lv


def report_any_accel(sed, visits, qd: QueryData, db, writer: B6Writer,
                     qbunch: int = 1, rescore_fn=None):
    """ANY mode on the accel path (inline printing in visit order,
    burst.c:4239-4275). It reads the two-step path's bunch-level visit
    lists (`accel_candidates`, `compute_ed_matrix_accel`), which this
    package does not have yet."""
    raise NotImplementedError(
        "ANY with an accelerator needs the two-step accelerated path "
        "(ROADMAP M7)")


def _emit_any(hits, qd: QueryData, db, writer: B6Writer, rescore_fn=None):
    from .engine import rescore_winners

    if not hits:
        return
    rd = db.rd
    if rescore_fn is None:
        rescore_fn = rescore_winners
    juni = np.array([h[0] for h in hits], dtype=np.int64)
    refpos = np.array([h[1] for h in hits], dtype=np.int64)
    eds = np.array([h[2] for h in hits], dtype=np.int64)
    pods = rescore_fn(qd, db, juni, refpos, eds, "ANY")
    # restore input order (rescore_winners re-sorts into pod order)
    pos = {(int(j), int(p)): t for t, (j, p, _) in enumerate(hits)}
    order = sorted(range(len(hits)),
                   key=lambda ix: pos[(int(pods.juni[ix]),
                                       int(pods.refpos[ix]))])
    for ix in order:
        i = int(pods.six[ix])
        qlen = int(qd.lens[i])
        rix = int(rd.ix_srt[pods.refpos[ix]])
        gq, gr = int(pods.gap_q[ix]), int(pods.gap_r[ix])
        num_gap = gq + gr
        mo = _m_off(rd, rix)
        st, edx = _coords(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                          qlen, gr, mo)
        for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
            writer.row(qd.heads_sorted[j], rd.heads[rix], pods.score[ix],
                       qlen + num_gap, int(pods.ed[ix]) - num_gap, num_gap,
                       qlen, st, edx, int(pods.ed[ix]),
                       int(j > qd.offset[i]), None)


def report_any(ed_matrix: np.ndarray, qd: QueryData, db,
               writer: B6Writer, rescore_fn=None):
    """ANY mode: realtime inline printing in the reference's
    single-thread full-path scan order (burst.c:4343-4475 at -t 1):
    clumps ascending, unibins ascending within each clump; a base
    query prints at its first qualifying (clump, unibin) event, and
    the printed lane is the first lane of that clump at or under the
    budget (burst.c:4444-4447: min = Emac for ANY, first z breaks)."""
    from .engine import rescore_winners

    if rescore_fn is None:
        rescore_fn = rescore_winners
    rd = db.rd
    nj = len(qd.seqs)
    budr = qd.ed[qd.six].astype(np.int64)
    # the reference re-sorts ALL unibins lexicographically before the
    # direct scan when RC twins exist (burst.c:3178-3181: fwd and RC
    # rows interleave in strcmp order); jrank is each row's position in
    # that scan. Without RC the rows are already uniquely sorted and
    # jrank is the identity.
    seq_keys = [s.tobytes() for s in qd.seqs]
    jrank = np.empty(nj, dtype=np.int64)
    jrank[sorted(range(nj), key=seq_keys.__getitem__)] = np.arange(nj)
    mask = ed_matrix.astype(np.int64) <= budr[:, None]
    # clump-level qualification: [nj, n_clumps] any-lane-under-budget
    tot = ed_matrix.shape[1]
    nc = -(-tot // VECSZ)
    maskp = np.zeros((nj, nc * VECSZ), dtype=bool)
    maskp[:, :tot] = mask
    anyc = maskp.reshape(nj, nc, VECSZ).any(axis=2)
    has_row = anyc.any(axis=1)
    first_c = np.argmax(anyc, axis=1)
    rows = np.nonzero(has_row)[0]
    hits = []  # (clump, scan rank, lane, juni, refpos)
    if len(rows):
        # per base query: earliest scan event = min (clump, scan rank)
        order = np.lexsort((jrank[rows], first_c[rows], qd.six[rows]))
        rs = rows[order]
        head = np.ones(len(rs), dtype=bool)
        six_s = qd.six[rs]
        np.not_equal(six_s[1:], six_s[:-1], out=head[1:])
        for j in rs[head]:
            c = int(first_c[j])
            lane = int(np.argmax(maskp[j, c * VECSZ: (c + 1) * VECSZ]))
            hits.append((c, int(jrank[j]), lane, int(j),
                         c * VECSZ + lane))
    hits.sort(key=lambda h: (h[0], h[1], h[2]))
    if not hits:
        return
    juni = np.array([h[3] for h in hits], dtype=np.int64)
    refpos = np.array([h[4] for h in hits], dtype=np.int64)
    eds = np.array([ed_matrix[h[3], h[4]] for h in hits], dtype=np.int64)
    pods = rescore_fn(qd, db, juni, refpos, eds, "ANY")
    # restore scan order (rescore_winners re-sorts into pod order)
    order = np.lexsort((pods.refpos % VECSZ, jrank[pods.juni],
                        pods.refpos // VECSZ))
    for ix in order:
        i = int(pods.six[ix])
        qlen = int(qd.lens[i])
        rix = int(rd.ix_srt[pods.refpos[ix]])
        gq, gr = int(pods.gap_q[ix]), int(pods.gap_r[ix])
        num_gap = gq + gr
        mo = _m_off(rd, rix)
        st, edx = _coords(bool(pods.rc[ix]), int(pods.final_pos[ix]),
                          qlen, gr, mo)
        for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
            writer.row(qd.heads_sorted[j], rd.heads[rix], pods.score[ix],
                       qlen + num_gap, int(pods.ed[ix]) - num_gap, num_gap,
                       qlen, st, edx, int(pods.ed[ix]),
                       int(j > qd.offset[i]), None)
