"""BEST-mode blast6 reporting, with the reference's exact semantics.

Copied from `burst_tpu.modes` (B6Writer, report_best and their helpers,
burst.c:4847-4891 row semantics): that module imports `Pods` from
`burst_tpu.engine`, which loads JAX, so it cannot be imported here
until the jax-free split of ROADMAP M0 lands.
"""
from __future__ import annotations

import numpy as np

from burst_tpu.process import QueryData, RefData

from .engine import Pods

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


def _suppress_best(tax: bytes, score: float, taxlevels) -> bytes:
    """Identity-based taxonomy suppression, BEST variant
    (burst.c:4874-4885)."""
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
    """Columnar BEST emission through the native b6 formatter; False ->
    the Python loop runs."""
    from burst_tpu.native import b6_format_native, load_host
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
