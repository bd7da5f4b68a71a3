"""Query and reference preprocessing.

Replicates the observable semantics of the reference's process_queries
(burst.c:2980-3223) and process_references
(burst.c:1837-2755, plain shearing path :2109-2141):

* queries: name truncation at whitespace, translation to 4-bit codes,
  lexicographic sort by translated sequence (strcmp order), dedup with
  an Offset map back to original rows, per-unique error budget
  ed = trunc(float32(1/THRES - 1) * len) capped at 254, optional
  reverse-complement twins;
* references: optional fixed-stride shearing with overlap ov =
  trunc(maxLenQ / THRES) and shear = max(ov, rebase_amt), length-sorted
  pods of tolerance LATENCY sorted lexicographically within, optional
  exact dedup keeping the lowest original index as representative.

Everything is kept columnar (numpy) so tiles feed the kernels directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import CHAR2NUM, RVT, translate, revcomp
from .devtime import spanned

LATENCY = 16


def _pad_matrix(seqs, lens: np.ndarray, wmax: int) -> np.ndarray:
    """[n, wmax] zero-padded letter matrix from ragged unit views.

    The native memcpy path matters at scale: a multi-GB database pads
    tens of millions of rows, and the per-row Python slicing loop alone
    costs minutes there."""
    n = len(seqs)
    out = np.zeros((n, wmax), dtype=np.uint8)
    from .native import pad_rows_native
    cat = np.concatenate(seqs) if n else np.zeros(0, np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    if pad_rows_native(cat, offs, out):
        return out
    for i in range(n):
        out[i, : lens[i]] = seqs[i]
    return out


def _cut_ws(h: bytes) -> bytes:
    """Truncate at the first space/tab; no allocation when absent
    (the overwhelmingly common case)."""
    i = h.find(b" ")
    j = h.find(b"\t")
    if i < 0:
        return h if j < 0 else h[:j]
    return h[:i] if j < 0 or i < j else h[:j]


def _process_queries_vec(headers, raw_seqs, thres: float, do_rc: bool,
                         xalpha: bool):
    """Vectorized fast path of process_queries (identical semantics).

    Builds one padded [tot, 32*W] code matrix, sorts/dedupes via a
    fixed-width bytes view (memcmp == strcmp order because in-sequence
    codes are nonzero and the pad byte 0 sorts below every code), and
    derives RC twins with one gather. Returns None -- falling back to
    the scalar path -- for inputs where padded-key comparison could
    diverge from exact strcmp order (empty reads, or reads containing
    the pad code 0 mid-sequence, i.e. junk bytes in the FASTA).
    """
    tot = len(raw_seqs)
    lens_all = np.fromiter((len(s) for s in raw_seqs), count=tot,
                           dtype=np.int64)
    if tot == 0 or lens_all.min() == 0:
        return None
    flat = np.concatenate(raw_seqs)
    if flat.dtype != np.uint8:
        return None
    if not xalpha:
        flat = CHAR2NUM[flat]
    if not flat.all():          # in-sequence pad code: exact path
        return None
    wpad = 32 * max(1, int(-(-lens_all.max() // 32)))
    mat = np.zeros((tot, wpad), dtype=np.uint8)
    mat[np.arange(wpad) < lens_all[:, None]] = flat
    keys = np.ascontiguousarray(mat).view(f"S{wpad}").ravel()
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    newu = np.empty(tot, dtype=bool)
    newu[0] = True
    newu[1:] = ks[1:] != ks[:-1]
    uniq_rows = np.nonzero(newu)[0]
    num_uniq = len(uniq_rows)
    offset = np.append(uniq_rows, tot).astype(np.int64)
    heads_sorted = [headers[i] for i in order]
    urows = order[uniq_rows]
    lens = lens_all[urows]
    umat = mat[urows]
    req_id = np.float32(1.0) / np.float32(thres) - np.float32(1.0)
    ed = np.minimum(254, (req_id * lens.astype(np.float32))
                    .astype(np.int64)).astype(np.int64)
    if do_rc:
        rcm = RVT[umat[:, ::-1]]
        live = np.arange(wpad) < lens[:, None]
        idx = np.minimum(np.arange(wpad) + (wpad - lens[:, None]),
                         wpad - 1)
        rc_rows = np.where(live, np.take_along_axis(rcm, idx, axis=1), 0)
        allmat = np.concatenate([umat, rc_rows])
        six = np.concatenate([np.arange(num_uniq, dtype=np.int64)] * 2)
        rc = np.zeros(2 * num_uniq, dtype=bool)
        rc[num_uniq:] = True
    else:
        allmat = umat
        six = np.arange(num_uniq, dtype=np.int64)
        rc = np.zeros(num_uniq, dtype=bool)
    rlens = lens[six]
    seqs = [allmat[j, : rlens[j]] for j in range(len(six))]
    qd = QueryData(
        heads_sorted=heads_sorted, offset=offset, seqs=seqs,
        six=six, rc=rc, lens=lens, ed=ed, num_uniq=num_uniq,
        max_len=int(lens.max()), min_len=int(lens.min()),
        xalpha=xalpha)
    # engine._query_matrix cache: same padded layout by construction
    qd._qmat = (allmat, rlens, np.maximum(1, -(-rlens // 32)))
    return qd


@dataclasses.dataclass
class QueryData:
    heads_sorted: list[bytes]        # per original row, in sorted order
    offset: np.ndarray               # [numUniq+1] -> first row of each unique
    seqs: list[np.ndarray]           # [numUniqRC] code arrays (fwd then rc)
    six: np.ndarray                  # [numUniqRC] -> base unique index
    rc: np.ndarray                   # [numUniqRC] bool
    lens: np.ndarray                 # [numUniq] true lengths
    ed: np.ndarray                   # [numUniq] error budgets
    num_uniq: int
    max_len: int
    min_len: int
    xalpha: bool = False


@spanned("burst.prep")
def process_queries(headers, raw_seqs, thres: float, do_rc: bool,
                    incl_whitespace: bool = False,
                    xalpha: bool = False) -> QueryData:
    tot = len(headers)
    if tot == 0:
        raise ValueError("ERROR: No queries found.")
    if not incl_whitespace:
        headers = [_cut_ws(h) for h in headers]
    qd = _process_queries_vec(headers, raw_seqs, thres, do_rc, xalpha)
    if qd is not None:
        return qd
    seqs = [s if xalpha else translate(s) for s in raw_seqs]
    keys = [s.tobytes() for s in seqs]
    order = sorted(range(tot), key=lambda i: keys[i])  # strcmp order
    heads_sorted = [headers[i] for i in order]

    uniq_rows = [0]
    for i in range(1, tot):
        if keys[order[i]] != keys[order[i - 1]]:
            uniq_rows.append(i)
    num_uniq = len(uniq_rows)
    offset = np.array(uniq_rows + [tot], dtype=np.int64)

    useqs = [seqs[order[r]] for r in uniq_rows]
    lens = np.array([len(s) for s in useqs], dtype=np.int64)
    req_id = np.float32(1.0) / np.float32(thres) - np.float32(1.0)
    ed = np.minimum(254, (req_id * lens.astype(np.float32))
                    .astype(np.int64)).astype(np.int64)

    six = list(range(num_uniq))
    rc = [False] * num_uniq
    all_seqs = list(useqs)
    if do_rc:
        for i in range(num_uniq):
            all_seqs.append(revcomp(useqs[i]))
            six.append(i)
            rc.append(True)
    return QueryData(
        heads_sorted=heads_sorted, offset=offset, seqs=all_seqs,
        six=np.array(six, dtype=np.int64), rc=np.array(rc, dtype=bool),
        lens=lens, ed=ed, num_uniq=num_uniq,
        max_len=int(lens.max()), min_len=int(lens.min()), xalpha=xalpha)


@spanned("burst.prep")
def bin_queries_for_accel(qd: QueryData, k: int, z: int,
                          do_heur: bool = False) -> np.ndarray:
    """Reorder unibins into accelerator bins: ambiguous (0), clear (1),
    super-ambiguous/ineligible (2), lexicographically sorted within each
    (burst.c:3113-3186). Mutates qd in place; returns [b0, b1] bin ends
    (accelerator handles unibins [0, b1); the full scan takes [b1, ...)).
    """
    n = len(qd.seqs)
    lens = qd.lens[qd.six].astype(np.int64)
    eds = qd.ed[qd.six].astype(np.int64)
    cached = getattr(qd, "_qmat", None)
    if cached is not None:
        qmat, m_pad = cached[0], cached[0].shape[1]
    else:
        m_pad = int(lens.max()) if n else 1
        qmat = np.zeros((n, m_pad), dtype=np.uint8)
        for j, s in enumerate(qd.seqs):
            qmat[j, : len(s)] = s
    # note: the reference increments totN only for codes > 4+Z but
    # demotes to the ambiguous bin for any code > 4 (burst.c:3113-3176)
    n_hard = (qmat > 4 + z).sum(axis=1)
    any_ambig = (qmat > 4).any(axis=1)
    stat = np.ones(n, dtype=np.int8)
    stat[any_ambig] = 0
    stat[n_hard > 5] = 2
    inel = lens < k
    if not do_heur:
        inel |= eds >= lens // np.int64(k)
    stat[inel] = 2
    skeys = np.ascontiguousarray(qmat).view(f"S{m_pad}").ravel()
    order = np.lexsort((skeys, stat))
    qd.seqs = [qd.seqs[j] for j in order]
    qd.six = qd.six[order]
    qd.rc = qd.rc[order]
    # row order changed: reorder the query-matrix cache in place,
    # drop the row-indexed Peq caches (rebuilt on demand)
    if cached is not None:
        qd._qmat = (qmat[order], cached[1][order], cached[2][order])
    for attr in ("_peqcache", "_peqdev"):
        if hasattr(qd, attr):
            delattr(qd, attr)
    stat = stat[order]
    b0 = int(np.searchsorted(stat, 1))
    b1 = int(np.searchsorted(stat, 2))
    return np.array([b0, b1], dtype=np.int64)


@dataclasses.dataclass
class RefData:
    heads: list[bytes]               # per unit (shear), parent header
    seqs: list[np.ndarray]           # per unit, translated codes
    lens: np.ndarray                 # [totR]
    start: np.ndarray | None         # [totR] offset into parent (REBASE)
    ix_srt: np.ndarray               # [totU] sorted+dedup position -> unit ix
    tmp_rix: np.ndarray              # [totR] sorted position -> unit ix
    dedup_ix: np.ndarray | None      # [totU+1] group starts into tmp_rix
    ref_map: np.ndarray              # [totR] unit -> dupe-suppression bin
    tot_units: int                   # number of alignment units (post-dedup)
    orig_tot: int                    # number of shears pre-dedup
    shear: int = 0                   # shear window (0 = unsheared)
    klen: np.ndarray | None = None   # true (pre-continuation) lengths;
    #                                  None/lens for EDX-read data
    centroids: np.ndarray | None = None   # [numRclumps,32] u8 (DO_FP)
    fp_p: np.ndarray | None = None        # [nf,32] u8 fingerprints
    fp_ptrs: np.ndarray | None = None     # [totU] twin pointers


VECSZ_REF = 16


def shear_refs(heads, seqs, lens, max_len_q: int, thres: float,
               rebase_amt: int):
    """Plain fixed-stride shearing (burst.c:2109-2141)."""
    ov = int(np.float32(max_len_q) / np.float32(thres))
    shear = max(ov, int(rebase_amt))
    new_h, new_s, new_len, new_start, new_pix = [], [], [], [], []
    max_len_r = shear + ov
    for i in range(len(seqs)):
        unit = int(lens[i]) - ov
        if unit < 0:
            unit = 1
        j = 0
        while j < unit:
            ln = min(int(lens[i]) - j, max_len_r)
            new_h.append(heads[i])
            new_s.append(seqs[i][j:j + ln])
            new_len.append(ln)
            new_start.append(j)
            new_pix.append(i)
            j += shear
        # note: a reference of length exactly ov yields unit == 0 and is
        # dropped -- the reference implementation does the same
        # (burst.c:2118-2122: only negative unit is clamped to 1)
    return new_h, new_s, np.array(new_len, np.int64), \
        np.array(new_start, np.int64), np.array(new_pix, np.int64), shear


def compressive_shear(headers, seqs, lens, max_len_q: int, thres: float,
                      rebase_amt: int, cparts: int = 1):
    """Duplicate-led compressive shearing (burst.c:1859-2107).

    Every eligible window start (13-mer of unambiguous codes, window =
    shear+ov fully inside the sequence) is bucket-sorted by content;
    adjacent fully-duplicate chains and near-duplicate ("sh") runs mark
    their window-start positions with a 4-bit dynamic-range-compressed
    flag; shearing then greedily restarts at the best flag within each
    shear span so duplicated regions land on shear boundaries and
    dedupe away. Flags are kept out-of-band (the reference ORs them
    into the sequence bytes' high nibbles and strips them after).
    """
    NL = 13
    min_shear = int(np.float32(max_len_q) / np.float32(thres))
    shear = max(min_shear, int(rebase_amt))
    ov = min_shear
    w = shear + ov
    eqlen = w - NL
    niblen = 24 - NL
    n_refs = len(seqs)
    flags = [np.zeros(len(s), dtype=np.uint8) for s in seqs]
    cparts = max(1, int(cparts))
    cp_range = n_refs // cparts + (1 if n_refs % cparts else 0)

    max_chain = 0
    max_sh = 0
    for rix in range(0, n_refs, cp_range):
        red = min(n_refs, rix + cp_range)
        # gather eligible windows of this partition
        re_parts, pe_parts, win_parts = [], [], []
        for i in range(rix, red):
            s = seqs[i]
            L = len(s)
            if L < w:
                continue
            nwin = L - w          # j in [0, L-w)
            if nwin <= 0:
                continue
            bad = (s[: nwin + NL - 1] > 4) | (s[: nwin + NL - 1] == 0)
            cb = np.concatenate(([0], np.cumsum(bad)))
            elig = (cb[NL:] - cb[:-NL]) == 0     # [nwin]
            js = np.nonzero(elig)[0]
            if not len(js):
                continue
            mat = np.lib.stride_tricks.sliding_window_view(s, w)[js]
            win_parts.append(np.ascontiguousarray(mat))
            re_parts.append(np.full(len(js), i, dtype=np.int64))
            pe_parts.append(js.astype(np.int64))
        if not win_parts:
            continue
        wins = np.concatenate(win_parts)
        re = np.concatenate(re_parts)
        pe = np.concatenate(pe_parts)
        keys = wins.view(f"S{w}").ravel()
        srt = np.argsort(keys, kind="stable")
        wins, re, pe = wins[srt], re[srt], pe[srt]
        n = len(wins)
        if n < 2:
            continue
        # adjacent comparisons: same bin (first NL), first-diff past NL
        a, b = wins[:-1], wins[1:]
        same_bin = (a[:, :NL] == b[:, :NL]).all(axis=1)       # [n-1]
        neq = a[:, NL:] != b[:, NL:]
        any_diff = neq.any(axis=1)
        where = np.where(any_diff, neq.argmax(axis=1), eqlen)
        is_sh = same_bin & (where >= niblen)
        is_ch = same_bin & (where >= eqlen)
        # run lengths ending at each pair (t indexes pair (t, t+1))
        t_ix = np.arange(n - 1)
        lf_sh = np.maximum.accumulate(np.where(~is_sh, t_ix, -1))
        lf_ch = np.maximum.accumulate(np.where(~is_ch, t_ix, -1))
        # breaks happen at within-bin pairs only (bin ends never flush)
        brk_sh = same_bin & (where < niblen)
        brk_ch = same_bin & (where < eqlen)
        if max_chain == 0 and max_sh == 0:
            # phase-2 quirk (burst.c:1966-1981): the sh counter never
            # resets inside a bin, so maxSh is the per-bin CUMULATIVE
            # count of qualifying pairs before the bin's last break;
            # maxChain is the usual run maximum.
            bs = np.nonzero(brk_sh)[0]
            if len(bs):
                bin_id = np.concatenate(
                    ([0], np.cumsum(~same_bin[:-1]))).astype(np.int64)
                cq = np.concatenate(([0], np.cumsum(is_sh)))
                bin_q0 = np.zeros(int(bin_id.max()) + 1, dtype=np.int64)
                firsts = np.concatenate(
                    ([0], np.nonzero(np.diff(bin_id))[0] + 1))
                bin_q0[bin_id[firsts]] = cq[firsts]
                cnt = cq[bs] - bin_q0[bin_id[bs]]
                if len(cnt):
                    max_sh = max(max_sh, int(cnt.max()))
            bc = np.nonzero(brk_ch)[0]
            bc = bc[bc > 0]
            if len(bc):
                chl = (bc - 1) - lf_ch[bc - 1]
                if len(chl):
                    max_chain = max(max_chain, int(chl.max()))
        sh1 = int(np.sqrt(np.float64(max_sh)) / 2)
        sh2 = sh1 * 4 // 3
        sh3 = sh1 * 3
        # marking (entry e of pair t is e = t+1's predecessor chain):
        # a break at pair t marks entries [t - run, t] (window starts)
        for t in np.nonzero(brk_sh)[0]:
            sh = int(t) - 1 - int(lf_sh[t - 1]) if t > 0 else 0
            if sh > sh1:
                conv = 3 if sh >= sh3 else 2 if sh >= sh2 else 1
                lo = t - sh
                for e in range(lo, t + 1):
                    flags[re[e]][pe[e]] |= np.uint8(conv << 4)
        for t in np.nonzero(brk_ch)[0]:
            chain = int(t) - 1 - int(lf_ch[t - 1]) if t > 0 else 0
            if chain and max_chain:
                tt = min(2048, chain * 2048 // max_chain)
                tt = max(tt, 1)          # clz(0) is UB in the reference
                conv = (tt.bit_length() - 1) + 4
                lo = t - chain
                for e in range(lo, t + 1):
                    flags[re[e]][pe[e]] |= np.uint8(conv << 4)

    # flag-led greedy rebase (burst.c:2052-2083)
    new_h, new_s, new_len, new_start, new_pix = [], [], [], [], []
    for i in range(n_refs):
        L = int(lens[i])
        fl = flags[i] >> 4
        end = 0
        pos = 0
        bst_flg = int(fl[0]) if L else 0
        while end < L:
            start = pos
            max_ix = min(L, pos + shear)
            seg = fl[pos + 1: max_ix]
            if len(seg):
                bf = int(seg.max())
                bi = pos + 1 + (len(seg) - 1 - int(np.argmax(seg[::-1])))
            else:
                bf = 0
                bi = pos
            if bf > bst_flg:
                pos = bi
            else:
                pos += shear
            end = min(max_ix + ov, L) if bst_flg > 3 else min(pos + ov, L)
            if pos < L:
                bst_flg = int(fl[pos])
            new_h.append(headers[i])
            new_s.append(seqs[i][start:end])
            new_len.append(end - start)
            new_start.append(start)
            new_pix.append(i)
    return new_h, new_s, np.array(new_len, np.int64), \
        np.array(new_start, np.int64), np.array(new_pix, np.int64), shear


def process_references(headers, raw_seqs, *, max_len_q: int = 0,
                       thres: float = 0.97, rebase: bool = False,
                       rebase_amt: int = 500, curate: int = 0,
                       xalpha: bool = False, do_fp: bool = False,
                       dbtype: str = "QUICK", cparts: int = 1,
                       z: int = 1, latency: int = LATENCY,
                       clustradius: int = 0) -> RefData:
    seqs = [s if xalpha else translate(s) for s in raw_seqs]
    parents = seqs
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    start = None
    pix = None
    shear = 0
    if rebase and dbtype == "DNA":
        headers, seqs, lens, start, pix, shear = compressive_shear(
            headers, seqs, lens, max_len_q, thres, rebase_amt, cparts)
    elif rebase:
        headers, seqs, lens, start, pix, shear = shear_refs(
            headers, seqs, lens, max_len_q, thres, rebase_amt)
    tot = len(seqs)

    # Length sort, then lexicographic sort within LATENCY pods.
    # The reference's within-pod comparator is a raw strcmp
    # (burst.c:1341-1344) on pointers into the parent sequence, so the
    # sort key runs PAST the shear end to the end of the parent (the
    # NUL separator): duplicate shears order by their parents' tails.
    # -l 0 disables sorting entirely (burst.c:2188-2190).
    no_sort = latency == 0
    if no_sort:
        order = np.arange(tot, dtype=np.int64)
    else:
        order = np.argsort(lens, kind="stable")
    lens_sorted = lens[order]
    lat = 0 if do_fp else latency
    srt = list(order)
    cur_tol = int(lens_sorted[0])
    prev = 0
    bounds = []
    if not no_sort:
        for i in range(1, tot):
            if int(lens_sorted[i]) > cur_tol + lat:
                cur_tol = int(lens_sorted[i])
                if i - prev > 1:
                    bounds.append((prev, i, False))
                prev = i
        if prev < tot - 1:
            bounds.append((prev, tot, True))

    # parent-tail sort keys (the reference comparator is a raw strcmp
    # on pointers into the parent, burst.c:1341-1344) are built LAZILY:
    # only the small-pod qsort branch compares past the shear end, and
    # materializing every tail is O(parent_len) bytes PER SHEAR --
    # ~parent_len/2 x shears/parent, i.e. hundreds of GB on a multi-GB
    # database
    if start is not None:
        def _tail(i):
            return parents[pix[i]][start[i]:].tobytes()
    else:
        def _tail(i):
            return seqs[i].tobytes()

    # big pods sort on a zero-padded fixed-width byte matrix: letter
    # codes are >= 1, so a full-width memcmp orders exactly like
    # (content-bounded-by-min-length, length) -- the tuxCmp key. Ties
    # (identical content AND length) must come out in REVERSE input
    # order (glibc merge anti-stability, burst.c:391-406), so rows
    # enter the stable argsort pre-ordered by DESCENDING unit index.
    wmax = int(lens.max()) if tot else 0
    use_mat = (not no_sort and tot > 1
               and (start is not None or wmax <= 4096))
    pad_s = None
    if use_mat:
        pad = _pad_matrix(seqs, lens, wmax)
        pad_s = pad.view(f"S{wmax}").ravel()
    for a, b, last in bounds:
        if last or b - a > 256:
            # parallel_sort_tuxedo (burst.c:391-406): NIB5 prefix
            # buckets + per-bucket qsort with tuxCmp, which compares
            # shear content bounded by min length, tie-breaks by
            # length, and NEVER returns 0 -- anti-stable for ties
            if pad_s is not None:
                sub = np.sort(np.asarray(srt[a:b], dtype=np.int64))[::-1]
                perm = np.argsort(pad_s[sub], kind="stable")
                srt[a:b] = list(sub[perm])
            else:
                sb = {ix: seqs[ix].tobytes() for ix in srt[a:b]}
                srt[a:b] = sorted(
                    srt[a:b],
                    key=lambda ix: (sb[ix], int(lens[ix]), -ix))
        else:
            # qsort(cmpPackSeq) = strcmp on parent tails, stable
            srt[a:b] = sorted(srt[a:b], key=lambda ix: (_tail(ix), ix))
    srt = np.array(srt, dtype=np.int64)

    dedup_ix = None
    tmp_rix = srt.copy()
    ix_srt = srt.copy()
    tot_units = tot
    if curate:
        # duplicates = equal length AND equal shear content
        # (burst.c:2203-2207); sort keys include parent tails so
        # compare the shear bytes themselves here. Padded rows are
        # equal iff content and length both are (codes >= 1 vs pad 0).
        if pad_s is not None:
            neq = np.ones(tot, dtype=bool)
            step = 4 << 20
            for c0 in range(0, tot - 1, step):
                c1 = min(c0 + step, tot - 1)
                neq[c0 + 1: c1 + 1] = \
                    pad_s[srt[c0:c1]] != pad_s[srt[c0 + 1:c1 + 1]]
            groups_arr = np.nonzero(neq)[0]
            uix = len(groups_arr)
            dedup_ix = np.concatenate(
                (groups_arr, [tot])).astype(np.int64)
        else:
            shear_keys = [seqs[i].tobytes() for i in range(tot)]
            groups = [0]
            for i in range(1, tot):
                if shear_keys[srt[i]] != shear_keys[srt[i - 1]]:
                    groups.append(i)
            uix = len(groups)
            dedup_ix = np.array(groups + [tot], dtype=np.int64)
        # lowest original index becomes the group representative via the
        # reference's min-displacement scan (burst.c:2216-2221): each
        # time a smaller member is found, the current front value takes
        # its place -- member order inside groups follows exactly
        gsz = np.diff(dedup_ix)
        for g in np.nonzero(gsz > 1)[0]:
            a, b = int(dedup_ix[g]), int(dedup_ix[g + 1])
            bix = srt[a]
            for mi in range(a + 1, b):
                if srt[mi] < bix:
                    bix = srt[mi]
                    srt[mi] = srt[a]
                    srt[a] = bix
        tmp_rix = srt.copy()
        ix_srt = srt[dedup_ix[:-1]].copy()
        tot_units = uix
    del pad_s
    if use_mat:
        del pad

    centroids = fp_p = fp_ptrs = None
    if do_fp and not xalpha:
        # FP-led clustering reorders the sorted units so each 16-wide
        # clump packs similar references (burst.c:2238-2686)
        from .fingerprint import cluster_references
        ix_srt, tmp_rix, dedup_ix, centroids, fp_p, fp_ptrs = \
            cluster_references(ix_srt, tmp_rix, dedup_ix, seqs, lens,
                               tot_units, tot, z, bool(curate),
                               clustradius=clustradius)

    # The reference's clump transpose reads ONE byte past each shear's
    # end into the parent (burst.c:2716-2718 uses '>= j'), bounded by
    # the clump's max true length, so the DP and the EDX nibbles see a
    # len+1 "continuation" byte. True lengths (klen) drive sorting,
    # dedupe and accelerator word collection; extended content drives
    # alignment and serialization.
    klen = lens.copy()
    if start is not None:
        clump_max = np.zeros(tot_units // VECSZ_REF + 1, dtype=np.int64)
        pos_arr = np.arange(tot_units)
        np.maximum.at(clump_max, pos_arr // VECSZ_REF,
                      lens[ix_srt[:tot_units]])
        ext_lens = lens.copy()
        new_seqs = list(seqs)
        u_arr = ix_srt[:tot_units]
        plens = np.fromiter((len(p) for p in parents), np.int64,
                            count=len(parents))
        ln_arr = lens[u_arr]
        ext_arr = np.minimum(
            np.minimum(ln_arr + 1,
                       clump_max[np.arange(tot_units) // VECSZ_REF]),
            plens[pix[u_arr]] - start[u_arr])
        grow = np.nonzero(ext_arr > ln_arr)[0]
        us = u_arr[grow].tolist()
        sts = start[u_arr[grow]].tolist()
        exts = ext_arr[grow].tolist()
        pxs = pix[u_arr[grow]].tolist()
        for u, st, ext, px in zip(us, sts, exts, pxs):
            new_seqs[u] = parents[px][st: st + ext]
            ext_lens[u] = ext
        seqs = new_seqs
        lens = ext_lens

    ref_map = np.arange(len(seqs), dtype=np.int64)  # raw-FASTA identity map
    return RefData(
        heads=headers, seqs=seqs, lens=lens, start=start,
        ix_srt=ix_srt, tmp_rix=tmp_rix, dedup_ix=dedup_ix, ref_map=ref_map,
        tot_units=tot_units, orig_tot=tot, shear=shear, klen=klen,
        centroids=centroids, fp_p=fp_p, fp_ptrs=fp_ptrs)
