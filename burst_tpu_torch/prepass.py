"""Prepass mode (-p): ultra-fast heuristic pre-matching.

Reproduces /root/reference/burst.c:3697-3992 byte-for-byte in
single-thread order: per unique query (sorted-dedup order, no RC twins,
no accelerator binning -- burst.c:3065,3113), scour k-mer hits per
clump on both strands, keep the top-ITER clumps per strand (insertion
top-sort: hits descending, first-touch tie order, burst.c:3703-3709),
pick the strand with more top hits, run the bounded ED-only DP on the
visited prefix (break at M[p] <= mmatch or M[p] < load), optionally
retry the other strand, then print directly with "fake" identity
(len-ED)/len -- no optimality guarantee, column 6 is a literal -1.

The reference's per-clump bounded DP (prune_ed_mat16, burst.c:901-995)
returns each lane's exact ED when <= the bound and 255 otherwise; here
exact per-unit EDs come from the batched Myers kernel and the bound
semantics are applied after the fact, which provably yields the same
printed rows (capped lanes always exceed the final print ceiling).

Counterpart of `burst_tpu.prepass`, numpy only but for the pair scan:
the exact per-unit EDs come from the port's `engine._pairs_min_ed` (K2
on the card, over tile slabs where the residency plan streams a
bucket), its deferred chunks resolved here into one array. The CLI's
-p calls `run_prepass(qd, db, acc, a, out_fh, taxonomy)` with
`qd = process_queries(heads, seqs, thres, False)`: prepass never makes
RC twins or accelerator bins (burst.c:3065, 3113); `a` holds the CLI's
"mode", "prepass" (ITER, 16 for a bare -p), "rc" and "heur".
"""
from __future__ import annotations

import numpy as np

from . import devtime, engine
from .engine import VECSZ
from .process import QueryData


def _scour_words(seq: np.ndarray, k: int) -> np.ndarray:
    """Rolling k-mers, runs reset by any code > 4 (burst.c:3746-3751)."""
    n = len(seq)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    c = seq.astype(np.int64)
    ok = c <= 4
    # run[j] = length of clean run ending at j = j - (last bad index <= j)
    idx = np.arange(n, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(ok, np.int64(-1), idx))
    run = np.where(ok, idx - last_bad, 0)
    ends = np.nonzero(run >= k)[0]
    if not len(ends):
        return np.zeros(0, dtype=np.int64)
    pw = (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    cm1 = c - 1
    words = np.zeros(len(ends), dtype=np.int64)
    for t in range(k):
        words += cm1[ends - (k - 1) + t] * pw[t]
    return words


def _topsort(cands: np.ndarray, hits: np.ndarray, iters: int):
    """Top-`iters` by hits desc, insertion (first-touch) tie order."""
    if not len(cands):
        return (np.zeros(iters, dtype=np.int64),
                np.zeros(iters, dtype=np.int64))
    srt = np.lexsort((np.arange(len(cands)), -hits))[:iters]
    M = np.zeros(iters, dtype=np.int64)
    Ix = np.zeros(iters, dtype=np.int64)
    M[: len(srt)] = hits[srt]
    Ix[: len(srt)] = cands[srt]
    return M, Ix


def _clump_hits(acc, words: np.ndarray, n_clumps: int):
    """(cands, hits, first_word) per clump, in scan first-touch order.

    Postings within one word's list are clump-ascending (the builder
    appends clump-major, burst.c:3414-3487), so the stream first-touch
    order equals lexicographic (first word occurrence, clump id) -- a
    key that survives per-host posting shards (parallel/multihost.py
    merges shard candidates under the same key)."""
    z3 = (np.zeros(0, np.int64),) * 3
    if not len(words):
        return z3
    starts, seg = acc.csr.lookup(words)
    total = int(seg.sum())
    if total == 0:
        return z3
    segc = np.concatenate(([0], np.cumsum(seg)))
    base = np.repeat(starts - segc[:-1], seg)
    flat = base + np.arange(total)
    cl = acc.csr.ids[flat].astype(np.int64)
    widx = np.repeat(np.arange(len(words), dtype=np.int64), seg)
    so = np.argsort(cl, kind="stable")   # stable: stream order kept
    cs = cl[so]
    head = np.empty(total, dtype=bool)
    head[0] = True
    np.not_equal(cs[1:], cs[:-1], out=head[1:])
    gid = np.cumsum(head) - 1
    hits = np.bincount(gid).astype(np.int64)
    cands = cs[head]
    fw = widx[so][head]                  # first word occurrence touching
    order = np.lexsort((cands, fw))
    return cands[order], hits[order], fw[order]


def _local_top_lists(qd, qk, acc, k: int, iters: int, nu: int,
                     do_rc: bool, n_clumps: int):
    """Per-query-strand top-ITER clump lists from the full index."""
    FM = np.zeros((nu, iters), dtype=np.int64)
    FI = np.zeros((nu, iters), dtype=np.int64)
    RM = np.zeros((nu, iters), dtype=np.int64)
    RI = np.zeros((nu, iters), dtype=np.int64)
    for i in range(nu):
        w = _scour_words(qd.seqs[i], k)
        c, h, _ = _clump_hits(acc, w, n_clumps)
        FM[i], FI[i] = _topsort(c, h, iters)
        if do_rc:
            w = _scour_words(qk.seqs[nu + i], k)
            c, h, _ = _clump_hits(acc, w, n_clumps)
            RM[i], RI[i] = _topsort(c, h, iters)
    return FM, FI, RM, RI


def pairs_min_ed(qk: QueryData, db, pj: np.ndarray, pp: np.ndarray
                 ) -> np.ndarray:
    """[len(pj)] exact min ED of each (row, unit) pair: the engine's
    deferred K2 chunks, fetched in one go and placed by part (255 where
    a pair has none, unclipped otherwise, as burst_tpu's array)."""
    out = np.full(len(pj), 255, dtype=np.int64)
    pending = engine._pairs_min_ed(qk, db, pj, pp)
    host = devtime.fetch([res for _, res in pending])
    for (part, _), h in zip(pending, host):
        out[part] = h[0][: len(part)]
    return out


def run_prepass(qd: QueryData, db, acc, a: dict, out_fh,
                taxonomy=None) -> int:
    """The full -p flow over the device database `db` (state.load_db);
    returns the reference's exit code 101."""
    import copy

    rd = db.rd
    mode = a["mode"]
    iters = int(a["prepass"])
    do_rc = a["rc"]
    do_heur = a["heur"]
    k = acc.k
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    nu = qd.num_uniq

    # clump print lengths (max unit length per clump, burst.c:2690-2699);
    # a multi-host run injects a cross-shard max (non-local lens read as
    # 0)
    clump_len = a.get("_clump_len")
    if clump_len is None:
        ulens = rd.lens[rd.ix_srt[: rd.tot_units]].astype(np.int64)
        clump_len = np.zeros(n_clumps, dtype=np.int64)
        np.maximum.at(clump_len, np.arange(rd.tot_units) // VECSZ, ulens)

    # kernel-side query set: fwd rows then rc rows
    from .alphabet import revcomp
    qk = copy.copy(qd)
    qk.seqs = list(qd.seqs[:nu])
    six = list(range(nu))
    rc_flags = [False] * nu
    if do_rc:
        qk.seqs += [revcomp(s) for s in qd.seqs[:nu]]
        six += list(range(nu))
        rc_flags += [True] * nu
    qk.six = np.array(six, dtype=np.int64)
    qk.rc = np.array(rc_flags, dtype=bool)
    # qk's row set diverges from qd's; drop the inherited row-indexed
    # caches (engine._query_matrix, the Peq planes of _peq_device) and
    # the batch's streaming counts: they rebuild on demand
    for attr in ("_qmat", "_peq_torch", "_stream"):
        qk.__dict__.pop(attr, None)

    # per-query-strand top lists and visited prefixes; a multi-host run
    # injects a shard-merging variant (parallel/multihost.py)
    top_lists = a.get("_top_lists_fn", _local_top_lists)
    FM, FI, RM, RI = top_lists(qd, qk, acc, k, iters, nu, do_rc,
                               n_clumps)

    lens = qd.lens.astype(np.int64)
    errs0 = qd.ed.astype(np.int64)
    kload = errs0 * k + k
    mmatch = np.where(kload < lens, lens - kload, 0)

    def visited_prefix(M: np.ndarray, mm: int) -> int:
        load = min(int(M[0]), int(M[0]) * 8 // iters)
        p = 0
        while p < iters and M[p] > mm and M[p] >= load:
            p += 1
        return p

    # batch exact per-unit EDs for all (strand, visited clump) pairs
    pj_parts, pp_parts = [], []
    strand1 = np.zeros(nu, dtype=bool)   # True = rc picked first
    pref1 = np.zeros(nu, dtype=np.int64)
    pref2 = np.zeros(nu, dtype=np.int64)
    lane = np.arange(VECSZ, dtype=np.int64)
    for i in range(nu):
        if FM[i, 0] == 0 and RM[i, 0] == 0:
            continue
        rc1 = FM[i, 0] < RM[i, 0]
        strand1[i] = rc1
        M1, I1 = (RM[i], RI[i]) if rc1 else (FM[i], FI[i])
        p1 = visited_prefix(M1, int(mmatch[i]))
        pref1[i] = p1
        rows = [(i + (nu if rc1 else 0), I1[:p1])]
        if do_rc and not do_heur:
            M2, I2 = (FM[i], FI[i]) if rc1 else (RM[i], RI[i])
            p2 = visited_prefix(M2, int(mmatch[i]))
            pref2[i] = p2
            rows.append((i + (0 if rc1 else nu), I2[:p2]))
        for jrow, clumps in rows:
            if not len(clumps):
                continue
            ps = (clumps[:, None] * VECSZ + lane).ravel()
            ps = ps[ps < rd.tot_units]
            pp_parts.append(ps)
            pj_parts.append(np.full(len(ps), jrow, dtype=np.int64))
    pairs_ed = a.get("_pairs_ed_fn", pairs_min_ed)
    if pj_parts:
        pj = np.concatenate(pj_parts)
        pp = np.concatenate(pp_parts)
        pe = pairs_ed(qk, db, pj, pp)
    else:
        # the pair list is identical on every host (top lists are
        # global), so skipping the collective here is symmetric too
        pj = pp = pe = np.zeros(0, dtype=np.int64)
    # (strand-row, unit) -> exact ED lookup
    ekey = pj * rd.tot_units + pp
    eso = np.argsort(ekey)
    ekey_s, pe_s = ekey[eso], pe[eso]

    def unit_ed(jrow: int, clump: int) -> np.ndarray:
        """[VECSZ] exact EDs (255 pad for missing tail units)."""
        out = np.full(VECSZ, 255, dtype=np.int64)
        base = clump * VECSZ
        nlanes = min(VECSZ, rd.tot_units - base)
        keys = jrow * rd.tot_units + base + np.arange(nlanes)
        loc = np.searchsorted(ekey_s, keys)
        out[:nlanes] = pe_s[loc]
        return out

    # sequential per-query emulation + printing
    for i in range(nu):
        if FM[i, 0] == 0 and RM[i, 0] == 0:
            continue
        length = int(lens[i])
        err_budget = int(errs0[i])

        def run_strand(rc: bool, prefix: int):
            """Emulate the p-loop; returns (p_stop, RefMin rows, gmin)."""
            M, Ix = (RM[i], RI[i]) if rc else (FM[i], FI[i])
            jrow = i + (nu if rc else 0)
            gmin = 1 << 30
            err = err_budget
            ref_min = np.full((iters, VECSZ), 255, dtype=np.int64)
            p = 0
            while p < prefix:
                e = unit_ed(jrow, int(Ix[p]))
                raw = length - int(M[p]) - k + 1
                if mode != "FORAGE":
                    err = min(gmin, err)
                bound = min(raw, err)
                mn = int(e.min())
                if mn > bound and bound < err:
                    bound = err          # the reference's retry
                if mn <= bound:
                    ref_min[p] = np.where(e <= bound, e, 255)
                    gmin = min(gmin, mn)
                    if mode == "ANY":
                        p += 1
                        break
                p += 1
            return p, ref_min, gmin

        rc1 = bool(strand1[i])
        p, ref_min, gmin = run_strand(rc1, int(pref1[i]))
        used_rc = rc1
        if gmin == 1 << 30:
            if do_heur or not do_rc:
                continue
            used_rc = not rc1
            p, ref_min, gmin = run_strand(used_rc, int(pref2[i]))
            if gmin == 1 << 30:
                continue
        M, Ix = (RM[i], RI[i]) if used_rc else (FM[i], FI[i])

        ceil = err_budget
        if mode != "FORAGE":
            ceil = min(gmin, ceil)
        flat_min = ref_min[:p].ravel()
        taxon = b""
        k_start = 0
        if mode == "CAPITALIST":
            min_ix = 1 << 62
            dv = 0
            olen = 0
            tax_set = False
            for j in np.nonzero(flat_min <= ceil)[0]:
                orix = (int(Ix[j >> 4]) << 4) + (int(j) & 15)
                if taxonomy is not None and rd.dedup_ix is not None:
                    for z in range(int(rd.dedup_ix[orix]),
                                   int(rd.dedup_ix[orix + 1])):
                        rix = int(rd.tmp_rix[z])
                        tp = taxonomy.lookup(rd.heads[rix])
                        if not tax_set:
                            taxon = tp
                            olen = len(taxon)
                            tax_set = True
                        else:
                            dv = 0
                            while dv < len(taxon) and dv < len(tp) and \
                                    taxon[dv] == tp[dv]:
                                dv += 1
                            taxon = taxon[:dv]
                elif taxonomy is not None:
                    rix = int(rd.ix_srt[orix])
                    tp = taxonomy.lookup(rd.heads[rix])
                    if not tax_set:
                        taxon, olen, tax_set = tp, len(tp), True
                    else:
                        dv = 0
                        while dv < len(taxon) and dv < len(tp) and \
                                taxon[dv] == tp[dv]:
                            dv += 1
                        taxon = taxon[:dv]
                if orix < min_ix:
                    min_ix = orix
                    k_start = int(j)
            if taxonomy is not None and len(taxon) < olen:
                while dv and (dv >= len(taxon) or taxon[dv] != 0x3B):
                    dv -= 1
                taxon = taxon[:dv]
        cap_taxon = taxon if mode == "CAPITALIST" and taxonomy else None

        for j in range(k_start, p << 4):
            if flat_min[j] > ceil:
                continue
            clump = int(Ix[j >> 4])
            orix = (clump << 4) + (j & 15)
            ed = int(flat_min[j])
            fake_id = float(length - ed) / length * 100.0
            if mode in ("FORAGE", "ALLPATHS") and rd.dedup_ix is not None:
                for z in range(int(rd.dedup_ix[orix]),
                               int(rd.dedup_ix[orix + 1])):
                    rix = int(rd.tmp_rix[z])
                    st = int(rd.start[rix]) if rd.start is not None else 1
                    edix = st + int(clump_len[clump])
                    tx = taxonomy.lookup(rd.heads[rix]) if taxonomy else b""
                    if used_rc:
                        st, edix = edix, st
                    _emit(out_fh, qd, i, rd.heads[rix], fake_id, length,
                          ed, st, edix, tx)
            else:
                rix = int(rd.ix_srt[orix])
                st = int(rd.start[rix]) if rd.start is not None else 1
                edix = st + int(clump_len[clump])
                if cap_taxon is not None:
                    tx = cap_taxon
                else:
                    tx = taxonomy.lookup(rd.heads[rix]) if taxonomy else b""
                if used_rc:
                    st, edix = edix, st
                _emit(out_fh, qd, i, rd.heads[rix], fake_id, length,
                      ed, st, edix, tx)
                if mode in ("BEST", "CAPITALIST", "ANY"):
                    break
    return 101


def _emit(out_fh, qd: QueryData, i: int, rhead: bytes, fake_id: float,
          length: int, ed: int, st: int, edix: int, taxon: bytes):
    """One prepass row (burst.c:3954-3977): col6 is a literal -1 and the
    taxonomy column is always present (empty when none)."""
    st_s = st if st < (1 << 31) else st - (1 << 32)
    for j in range(int(qd.offset[i]), int(qd.offset[i + 1])):
        out_fh.write("%s\t%s\t%f\t%u\t%u\t-1\t%u\t%u\t%d\t%u\t%u\t%u\t%s\n"
                     % (qd.heads_sorted[j].decode("latin-1"),
                        rhead.decode("latin-1"), fake_id, length + ed, ed,
                        1, length, st_s, edix & 0xFFFFFFFF, ed,
                        int(j > qd.offset[i]),
                        taxon.decode("latin-1")))
