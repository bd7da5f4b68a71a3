"""Fingerprints ("Prince"): 256-bit patterned k-mer presence sketches.

Replicates burst.c:1358-1692 and the FP-led greedy
clusterer (burst.c:2238-2686). A fingerprint sets bit w for every 4-mer
(2 bits per base, 8-bit word) that FOLLOWS an 'A'-compatible base; refs
use IUPAC ambiguity expansion, and references containing N get a second
"N-free" twin print (pattern excludes N, windows containing N skipped).

Clustering reorders the sorted+deduped units so each 16-wide clump
packs similar references: a counting-sort band pass over the prints'
leading 24 bits, then a greedy min-union-popcount sweep, then (with
-cr N) N rounds of EM refinement (burst.c:2515-2602): random cluster
pairings with exhaustive member-swap hill descent on the summed
union popcounts. Single-threaded the reference is deterministic (its
round seed is glibc's unseeded rand()); we replicate that stream, so
-cr output is byte-identical to the oracle at -t 1. Note the
reference serializes the PRE-refinement greedy centroids in the
non-N-penalized case (PC is never rebuilt after EM, burst.c:2601);
we keep that quirk, and recompute centroids only under -z like it
does (burst.c:2673-2677).

Everything here runs at DB build time only; search-time FP screens are
pure lower-bound skips (burst.c:4171-4183) that cannot change output.
"""
from __future__ import annotations

import os

import numpy as np

NL = 4
# pattern compatibility with 'A' (burst.c:1370-1371)
A_COMPAT = np.array([0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1],
                    dtype=bool)
A_COMPNN = np.array([0, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1],
                    dtype=bool)
AMBIG_SETS = {1: (0,), 2: (1,), 3: (2,), 4: (3,), 5: (0, 1, 2, 3),
              6: (2, 3), 7: (0, 1), 8: (0, 2), 9: (1, 3), 10: (1, 2),
              11: (0, 3), 12: (1, 2, 3), 13: (0, 1, 2), 14: (0, 1, 3),
              15: (0, 2, 3)}

_BIT = (np.uint8(1) << np.arange(8, dtype=np.uint8))


def _set_bits(fp: np.ndarray, words: np.ndarray):
    """OR bits `words` (0..255) into one 32-byte fingerprint row."""
    np.bitwise_or.at(fp, words >> 3, _BIT[words & 7])


def _expand_window(s: np.ndarray, j: int, out: list, w: int = 0,
                   ix: int = 0):
    if ix == NL:
        out.append(w)
        return
    for b in AMBIG_SETS.get(int(s[j + ix]), ()):
        _expand_window(s, j, out, (w << 2) | b, ix + 1)


def fingerprint_ref(s: np.ndarray) -> tuple[np.ndarray, bool]:
    """(print, has_N) for one reference unit (true-length content).

    Pattern positions j in [0, L-5] with A_COMPAT[s[j]]; the following
    4 bases hash with full ambiguity expansion (burst.c:1399-1406).
    """
    fp = np.zeros(32, dtype=np.uint8)
    L = len(s)
    if L <= NL:
        return fp, False
    pat = s[: L - NL - 1 + 1]            # j + NL < L  ->  j <= L-5
    pmask = A_COMPAT[pat]
    has_n = bool((pat == 5).any())
    js = np.nonzero(pmask)[0]
    if len(js) == 0:
        return fp, has_n
    nxt = np.lib.stride_tricks.sliding_window_view(s, NL)[1:]   # at j+1
    clean = (nxt[js] >= 1).all(axis=1) & (nxt[js] <= 4).all(axis=1)
    cj = js[clean]
    if len(cj):
        w4 = nxt[cj].astype(np.uint8) - 1
        words = (w4[:, 0] << 6) | (w4[:, 1] << 4) | (w4[:, 2] << 2) \
            | w4[:, 3]
        _set_bits(fp, words)
    for j in js[~clean]:
        tmp: list = []
        _expand_window(s, int(j) + 1, tmp)
        if tmp:
            _set_bits(fp, np.array(tmp, dtype=np.int64))
    return fp, has_n


def fingerprint_ref_nn(s: np.ndarray) -> np.ndarray:
    """N-free twin print (burst.c:1409-1419): pattern A_COMPNN, windows
    containing an N are skipped with the reference's j-advance."""
    fp = np.zeros(32, dtype=np.uint8)
    L = len(s)
    j = 0
    while j + NL < L:
        if A_COMPNN[s[j]]:
            if s[j + 1] == 5:
                j += 2
                continue
            if s[j + 2] == 5:
                j += 3
                continue
            if s[j + 3] == 5:
                j += 4
                continue
            if s[j + 4] == 5:
                j += 5
                continue
            tmp: list = []
            _expand_window(s, j + 1, tmp)
            if tmp:
                _set_bits(fp, np.array(tmp, dtype=np.int64))
        j += 1
    return fp


def fingerprint_query(s: np.ndarray) -> np.ndarray:
    """Query print (burst.c:1491-1506): pattern 'A' only, ambiguous
    windows skipped, non-overlapping (j += 4 after a hit)."""
    fp = np.zeros(32, dtype=np.uint8)
    L = len(s)
    j = 0
    while j + NL < L:
        if s[j] == 1:
            if s[j + 1] > 4:
                j += 2
                continue
            if s[j + 2] > 4:
                j += 3
                continue
            if s[j + 3] > 4:
                j += 4
                continue
            if s[j + 4] > 4:
                j += 5
                continue
            w = ((int(s[j + 1]) - 1) << 6) | ((int(s[j + 2]) - 1) << 4) \
                | ((int(s[j + 3]) - 1) << 2) | (int(s[j + 4]) - 1)
            fp[w >> 3] |= 1 << (w & 7)
            j += 5
            continue
        j += 1
    return fp


def create_ref_fingerprints(seqs_sorted: list[np.ndarray]):
    """Prints for sorted units + N-free twins (create_fingerprints with
    isRef=1, dualAmbig=1, burst.c:1396-1421).

    Returns (P [nf,32] uint8, ptrs [n] int64): ptrs[i] = i or the twin
    index (>= n) for units containing N.
    """
    n = len(seqs_sorted)
    prints = []
    ptrs = np.arange(n, dtype=np.int64)
    twins = []
    for i, s in enumerate(seqs_sorted):
        fp, has_n = fingerprint_ref(s)
        prints.append(fp)
        if has_n:
            ptrs[i] = n + len(twins)
            twins.append(fingerprint_ref_nn(s))
    return np.array(prints + twins, dtype=np.uint8).reshape(-1, 32), ptrs


def _pop_rows(P: np.ndarray) -> np.ndarray:
    return np.bitwise_count(P).sum(axis=1).astype(np.int64)


def greedy_cluster(P: np.ndarray, tot_r: int):
    """The reference's default greedy clusterer (burst.c:2496-2537).

    P: [tot16, 32] uint8 working prints (modified in place).
    Returns (ix_array, centroids [tot16//16, 32]).
    """
    tot16 = len(P) - 1            # P carries one pad row (burst.c:2371)
    ix = np.arange(tot16, dtype=np.int64)
    pc = np.zeros((tot16 // 16, 32), dtype=np.uint8)
    if tot_r == 0:
        return ix, pc
    centroid = P[0].copy()
    for j in range(1, tot_r):
        rest = P[j:tot_r]
        uni = np.bitwise_count(rest | centroid).sum(axis=1)
        m = uni.min()
        tied = np.nonzero(uni == m)[0]
        if len(tied) > 1:
            dist = np.bitwise_count(rest[tied] ^ centroid).sum(axis=1)
            mix = j + int(tied[int(np.argmin(dist))])
        else:
            mix = j + int(tied[0])
        centroid |= P[mix]
        P[[j, mix]] = P[[mix, j]]
        ix[[j, mix]] = ix[[mix, j]]
        if not ((j + 1) & 15):
            pc[j >> 4] = centroid
            centroid = P[j + 1].copy()
        if tot_r < tot16:
            pc[tot_r >> 4] = centroid
    return ix, pc


_GLIBC_RAND1 = 1804289383        # first unseeded glibc rand()
_M64 = (1 << 64) - 1


def _qrand64(x: int) -> int:
    """xorshift64 (burst.c:1690-1691), on a masked python int."""
    x = (x ^ (x << 13)) & _M64
    x ^= x >> 7
    return (x ^ (x << 17)) & _M64


def em_refine(p: np.ndarray, ix_array: np.ndarray, tot_r: int,
              rounds: int) -> np.ndarray:
    """EM cluster-refinement loop (-cr, burst.c:2515-2602).

    Each round pairs up the clusters by a seeded random shuffle, then
    for every pair exhaustively tries swapping each member of one
    clump with each member of the other, keeping a swap iff it
    strictly lowers the summed union popcount of the two clumps.

    `p` is the band-sorted print table (twin-swapped under -z) and
    `ix_array` the greedy clusterer's permutation over [0, tot16);
    returns the refined permutation. Replicates the reference's
    single-thread behavior exactly, including its seeding (thread 0's
    seed is 1 + the running xorshift state, initialised from the
    first unseeded glibc rand()) and its quirk that the last shuffle
    slot reads an uninitialised Cache entry (see the junk-model
    comment below; BURST_TPU_EM_TAIL selects the modelled value).
    """
    tot16 = len(ix_array)
    n_clus = tot16 >> 4
    if n_clus == 0 or rounds <= 0:
        return ix_array
    ix_array = np.ascontiguousarray(ix_array, dtype=np.int64).copy()
    P = np.zeros((tot16, 32), dtype=np.uint8)
    live = ix_array < tot_r                    # padding rows stay zero
    P[live] = p[ix_array[live]]
    clus_pop = np.bitwise_count(
        np.bitwise_or.reduce(P.reshape(n_clus, 16, 32), axis=1)
    ).sum(axis=1).astype(np.int64)
    shf = list(range(tot16))
    # The reference reads one uninitialised Cache slot (z = n_clus-1,
    # burst.c:2554-2563): recycled heap bytes -- in practice old
    # fingerprint data from the just-freed print table, so its value
    # depends on the allocator's chunk reuse. Two regimes exist and
    # both are modelled here, selected by BURST_TPU_EM_TAIL:
    #   0 (default): the recycled bytes were zero -- the common case
    #     for small DBs, whose sparse prints are mostly zero bytes;
    #     verified byte-identical to the oracle on <=200-ref DBs.
    #   >= n_clus: nonzero junk. ANY such value behaves identically:
    #     the shuffle parks shf[n_clus-1] in ShfIx[junk] and pulls in
    #     the previously parked id, and an out-of-range id reaching a
    #     paired slot yields empty swap loops in the reference too
    #     (r1 = MIN(totR, c1o+16) < c1o); verified byte-identical on
    #     300-ref DBs for cr in {1,4,7,25,50}.
    # Values in [1, n_clus) are possible in principle but were never
    # observed. This is the one unknowable in -cr replication; the
    # algorithm itself (seed stream, shuffle, swap descent) is exact.
    tail = int(os.environ.get("BURST_TPU_EM_TAIL", "0"))
    tail = max(0, min(tail, tot16 - 1))
    cache = [0] * n_clus
    cache[n_clus - 1] = tail
    tot2 = n_clus - (n_clus & 1)
    _dbg = os.environ.get("BURST_TPU_EM_DEBUG")
    mseed = _GLIBC_RAND1
    for _rnd in range(rounds):
        seed = (1 + mseed) & _M64
        for z in range(n_clus - 1):
            seed = _qrand64(seed)
            cache[z] = (seed & 0xFFFFFFFF) % (n_clus - z) + z
        mseed = seed
        for z in range(n_clus):
            r = cache[z]
            shf[z], shf[r] = shf[r], shf[z]
        from .native import em_swap_pairs_native
        if em_swap_pairs_native(
                P, np.asarray(shf[:tot2], dtype=np.int64),
                clus_pop, ix_array, tot_r):
            # native descent did this round's pairs (production scale:
            # the Python loop below is its executable spec, kept as
            # the no-compiler fallback and the differential oracle)
            if _dbg:
                print(f"[em r{_rnd}] cur={int(clus_pop.sum())} "
                      f"shf={shf[:n_clus]}")
            continue
        for j in range(0, tot2, 2):
            c1, c2 = shf[j], shf[j + 1]
            c1o, c2o = c1 << 4, c2 << 4
            r1, r2 = min(tot_r, c1o + 16), min(tot_r, c2o + 16)
            for k in range(c1o, r1):
                rows1 = P[c1o: c1o + 16]
                ex1 = np.bitwise_or.reduce(
                    np.delete(rows1, k - c1o, axis=0), axis=0)
                m = c2o
                while m < r2:
                    rows2 = P[c2o: c2o + 16]
                    # OR of clump2 minus each candidate row, via
                    # prefix/suffix unions
                    pre = np.zeros((17, 32), dtype=np.uint8)
                    suf = np.zeros((17, 32), dtype=np.uint8)
                    for t in range(16):
                        pre[t + 1] = pre[t] | rows2[t]
                        suf[15 - t] = suf[16 - t] | rows2[15 - t]
                    mm = np.arange(m - c2o, r2 - c2o)
                    new1 = np.bitwise_count(
                        ex1[None, :] | rows2[mm]).sum(axis=1)
                    new2 = np.bitwise_count(
                        (pre[mm] | suf[mm + 1]) | P[k][None, :]
                    ).sum(axis=1)
                    better = np.nonzero(
                        new1 + new2 < clus_pop[c1] + clus_pop[c2])[0]
                    if len(better) == 0:
                        break
                    hit = int(better[0])
                    mi = m + hit
                    tmp = P[k].copy()
                    P[k] = P[mi]
                    P[mi] = tmp
                    clus_pop[c1] = int(new1[hit])
                    clus_pop[c2] = int(new2[hit])
                    ix_array[k], ix_array[mi] = ix_array[mi], ix_array[k]
                    ex1 = np.bitwise_or.reduce(
                        np.delete(P[c1o: c1o + 16], k - c1o, axis=0),
                        axis=0)
                    m = mi + 1
        if _dbg:
            print(f"[em r{_rnd}] cur={int(clus_pop.sum())} "
                  f"shf={shf[:n_clus]}")
    return ix_array


def cluster_references(ix_srt, tmp_rix, dedup_ix, seqs, klen, tot_r,
                       orig_tot, z: int, curate: bool,
                       clustradius: int = 0):
    """FP band sort + greedy clustering; returns the reordered
    (ix_srt, tmp_rix, dedup_ix, centroids, fp_p, fp_ptrs)."""
    seqs_sorted = [np.asarray(seqs[ix_srt[p]][: int(klen[ix_srt[p]])])
                   for p in range(tot_r)]
    P, ptrs = create_ref_fingerprints(seqs_sorted)
    p = P.copy()
    if z:
        # cluster on the N-free twins (burst.c:2244-2249)
        for i in range(tot_r):
            t = p[i].copy()
            p[i] = p[ptrs[i]]
            p[ptrs[i]] = t

    def _reorder(order):
        nonlocal ix_srt, tmp_rix, dedup_ix, p, ptrs
        order = np.asarray(order, dtype=np.int64)
        if curate and dedup_ix is not None:
            new_orig = np.empty(orig_tot, dtype=np.int64)
            new_dedup = np.empty(tot_r + 1, dtype=np.int64)
            jj = 0
            for i in range(tot_r):
                new_dedup[i] = jj
                a, b = int(dedup_ix[order[i]]), int(dedup_ix[order[i] + 1])
                new_orig[jj: jj + b - a] = tmp_rix[a:b]
                jj += b - a
            new_dedup[tot_r] = orig_tot
            tmp_rix = new_orig
            dedup_ix = new_dedup
            ix_srt = new_orig[new_dedup[:-1]]
        else:
            ix_srt = ix_srt[order]
            tmp_rix = ix_srt.copy()
        new_ptrs = np.where(ptrs[order] >= tot_r, ptrs[order],
                            np.arange(tot_r, dtype=np.int64))
        new_p = p.copy()
        new_p[:tot_r] = p[order]
        p = new_p
        ptrs = new_ptrs

    # band pass: counting sort by the prints' leading 24 bits
    # (burst.c:2277-2289: first little-endian u32 >> 8)
    key = (p[:tot_r, 0].astype(np.int64)
           | (p[:tot_r, 1].astype(np.int64) << 8)
           | (p[:tot_r, 2].astype(np.int64) << 16)
           | (p[:tot_r, 3].astype(np.int64) << 24)) >> 8
    word_range = np.argsort(key, kind="stable")
    _reorder(word_range)

    tot16 = tot_r + ((16 - (tot_r & 15)) & 15)
    work = np.zeros((tot16 + 1, 32), dtype=np.uint8)
    work[:tot_r] = p[:tot_r]
    ix_array, pc = greedy_cluster(work, tot_r)
    if clustradius:
        ix_array = em_refine(p, ix_array, tot_r, clustradius)
    # greedy swaps stay within [0, tot_r); padding rows keep their spot
    _reorder(ix_array[:tot_r])

    if z:
        # swap the ambiguous prints back; recompute centroids. The
        # reference's recompute loop runs to the clump boundary past
        # totR, ORing twin prints into the last centroid
        # (burst.c:2674-2679) -- replicated via a padded view.
        for i in range(tot_r):
            t = p[i].copy()
            p[i] = p[ptrs[i]]
            p[ptrs[i]] = t
        n_clumps = (tot_r + 15) // 16
        padded = np.zeros((n_clumps * 16, 32), dtype=np.uint8)
        padded[: len(p)] = p[: n_clumps * 16]
        pc = np.bitwise_or.reduce(
            padded.reshape(n_clumps, 16, 32), axis=1)
    return ix_srt, tmp_rix, dedup_ix, pc, p, ptrs
