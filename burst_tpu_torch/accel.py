"""Accelerator (ACX): k-mer prefilter index, byte-compatible with the
reference (burst.c:3304-3594).

Build: for every 16-reference clump, collect the set of unique k-mers
occurring in any member (with IUPAC ambiguity expansion), and append the
clump id to each k-mer's postings list. Clumps whose ambiguity expansion
exceeds the budget go to the BadList and are always aligned.

Search ("scour"): decompose each query into its k-mers (with ambiguity
expansion for ambiguous queries), look up postings, and count per-clump
hits; a clump is a candidate iff hits > qlen - (err+1)*k (the q-gram
pigeonhole bound, burst.c:4091-4095), which preserves the optimality
guarantee. k = 15 matches the burst15 build; k = 12 matches burst12.

TPU mapping note: scour is a host-side sparse gather (numpy); the
device work stays in the batched DP kernels which receive only the
candidate pairs.
"""
from __future__ import annotations

import numpy as np

from .process import RefData

VECSZ = 16

# IUPAC code -> constituent 2-bit bases (burst.c:1372-1375 AMBIGS)
AMBIGS = {5: (0, 1, 2, 3), 6: (2, 3), 7: (0, 1), 8: (0, 2), 9: (1, 3),
          10: (1, 2), 11: (0, 3), 12: (1, 2, 3), 13: (0, 1, 2),
          14: (0, 1, 3), 15: (0, 2, 3)}

# Reference's expansion-cost tables (burst.c:3322-3325). IPOW4[3] is 61
# in the reference (a typo for 64) -- replicated for byte-compatibility.
IPOW3 = [3 ** i for i in range(16)]
IPOW4 = [1, 4, 16, 61, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
         4194304, 16777216, 67108864, 268435456, 1073741824]


class SparseCSR:
    """Sparse word->postings map (the 'Forest', burst.c:3535-3594).

    The dense 4^k offsets table is never materialized in memory -- at
    k=15 every pass over a 4^k array costs tens of seconds in RAM
    bandwidth alone. Lookups binary-search the sorted nonzero words.
    """

    def __init__(self, nzw: np.ndarray, cnt: np.ndarray, ids: np.ndarray):
        self.nzw = nzw              # sorted words with nonzero postings
        self.cnt = cnt              # postings count per nz word (int64)
        self.start = np.concatenate(
            ([0], np.cumsum(cnt)[:-1])).astype(np.int64) if len(cnt) \
            else np.zeros(0, np.int64)
        self.ids = ids              # concatenated postings (uint32)
        self._rank = None           # dense word->rank+1 table (lazy)
        self._rank_span = 0

    def _dense_rank(self, span: int):
        """Dense O(1) lookup table; worth it up to 4^13 (268MB)."""
        if self._rank is None:
            self._rank = np.zeros(span, dtype=np.uint32)
            self._rank[self.nzw] = np.arange(
                1, len(self.nzw) + 1, dtype=np.uint32)
            self._rank_span = span
        return self._rank

    def lookup(self, words: np.ndarray):
        """(starts, lens) per query word; absent words get len 0."""
        if len(self.nzw) == 0:
            z = np.zeros(len(words), dtype=np.int64)
            return z, z
        span = int(self.nzw[-1]) + 1
        if span <= (1 << 26):
            r = self._dense_rank(span)[np.minimum(words, span - 1)]
            hit = (r > 0) & (words < span)
            pos = np.where(hit, r.astype(np.int64) - 1, 0)
        else:
            pos = np.searchsorted(self.nzw, words)
            pos = np.minimum(pos, len(self.nzw) - 1)
            hit = self.nzw[pos] == words
        lens = np.where(hit, self.cnt[pos], 0)
        starts = np.where(hit, self.start[pos], 0)
        return starts, lens


class Accelerator:
    def __init__(self, k: int, csr: SparseCSR, bad: np.ndarray, z: int):
        self.k = k
        self.csr = csr              # clump-granular postings
        self.bad = bad              # BadList clump ids
        self.z = z
        self.u_csr = None           # unit-granular postings (lazy, not
        #                             serialized; see build_unit_index)

    @property
    def ids(self) -> np.ndarray:
        return self.csr.ids


def _expand_words(seq: np.ndarray, j0: int, k: int, out: list):
    """DFS ambiguity expansion of the k-mer at j0 (countAmbigScour)."""
    stack = [(0, 0)]
    while stack:
        ix, w = stack.pop()
        if ix == k:
            out.append(w)
            continue
        c = int(seq[j0 + ix])
        if 1 <= c <= 4:
            stack.append((ix + 1, (w << 2) | (c - 1)))
        else:
            for b in reversed(AMBIGS.get(c, ())):
                stack.append((ix + 1, (w << 2) | b))


def _clump_words(seqs: list[np.ndarray], k: int, z: int,
                 skip_ambig: bool) -> np.ndarray:
    """Unique k-mer words of one clump, in first-discovery order."""
    seen: dict[int, None] = {}
    ambig_thresh = 4 + z    # letters above this trigger expansion
    for s in seqs:
        n = len(s)
        if n < k:
            continue
        has_ambig = bool((s > ambig_thresh).any())
        if skip_ambig or z:
            # skip windows containing the skip code(s)
            skip_code_hit = (s >= 5) if skip_ambig else (s == 5)
            j = 0
            while j + k <= n:
                w = np.nonzero(skip_code_hit[j:j + k])[0]
                if w.size:
                    j += int(w[0]) + 1
                    continue
                if has_ambig and bool((s[j:j + k] > ambig_thresh).any()):
                    tmp: list[int] = []
                    _expand_words(s, j, k, tmp)
                    for v in tmp:
                        seen.setdefault(v, None)
                else:
                    v = 0
                    for t in range(k):
                        v = (v << 2) | (int(s[j + t]) - 1)
                    seen.setdefault(v, None)
                j += 1
        elif has_ambig:
            for j in range(n - k + 1):
                tmp = []
                _expand_words(s, j, k, tmp)
                for v in tmp:
                    seen.setdefault(v, None)
        else:
            b = (s.astype(np.int64) - 1)
            win = np.lib.stride_tricks.sliding_window_view(b, k)
            pw = (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
            words = win @ pw
            for v in words:
                seen.setdefault(int(v), None)
    return np.fromiter(seen.keys(), dtype=np.int64, count=len(seen))



def _unit_kseq(rd, p: int):
    """Unit content truncated to its TRUE length (pre-continuation byte;
    see process.RefData.klen) -- the reference's accelerator collects
    words over RefLen, not the transpose-extended content."""
    u = rd.ix_srt[p]
    s = rd.seqs[u]
    if getattr(rd, "klen", None) is not None:
        return s[: int(rd.klen[u])]
    return s


def _clump_is_bad(seqs: list[np.ndarray], k: int, z: int) -> bool:
    """Ambiguity-expansion budget check (burst.c:3341-3353), literal."""
    full_size = (1 << 31) - 1 if k > 14 else 1 << 24
    ipow = IPOW3 if z else IPOW4
    ambig = 4 + z
    rng = k - 1
    tsum = 0
    for s in seqs:
        n = len(s)
        if n < k:
            continue
        asum = 0
        for j in range(n):
            if j >= rng:
                tsum += ipow[asum]
                if s[j - rng] > ambig:
                    asum -= 1
            if s[j] > ambig:
                asum += 1
            if tsum >= full_size:
                return True
    return False


def _assemble_csr(words_parts: list[np.ndarray],
                  src_parts: list[np.ndarray]) -> SparseCSR:
    """SparseCSR from per-source word lists (stable source order)."""
    if not words_parts:
        z = np.zeros(0, dtype=np.int64)
        return SparseCSR(z, z, np.zeros(0, dtype=np.uint32))
    all_w = np.concatenate(words_parts)
    all_s = np.concatenate(src_parts)
    srt = np.argsort(all_w, kind="stable")   # keeps source order per word
    ids = all_s[srt].astype(np.uint32)
    nzw, cnt = np.unique(all_w[srt], return_counts=True)
    return SparseCSR(nzw, cnt.astype(np.int64), ids)


def _unit_lens(rd: RefData) -> np.ndarray:
    """True (pre-continuation) unit lengths in sorted-unit order."""
    if getattr(rd, "klen", None) is not None:
        return rd.klen[rd.ix_srt[: rd.tot_units]].astype(np.int64)
    return np.array([len(rd.seqs[rd.ix_srt[p]])
                     for p in range(rd.tot_units)], dtype=np.int64)


def build_accelerator(rd: RefData, k: int = 15, z: int = 1,
                      skip_ambig: bool = False) -> Accelerator:
    """Clump-granular k-mer postings + BadList (burst.c:3304-3532).

    Clumps whose every member is pure ACGT (the overwhelming majority
    at database scale) take a fully vectorized path: one rolling-word
    pass over the concatenated units, one unique() over packed
    (clump, word) keys. Clumps containing any IUPAC letter keep the
    literal per-clump expansion/BadList logic. Output is identical --
    per-word postings ascend by clump either way, and word order within
    a clump never reaches the serialized form."""
    tot_rc = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    n_units = rd.tot_units
    lens = _unit_lens(rd)
    span = np.int64(1) << np.int64(2 * k)

    # per-unit purity without a per-letter Python pass
    cat = np.concatenate(
        [rd.seqs[rd.ix_srt[p]][: lens[p]] for p in range(n_units)]
    ) if n_units else np.zeros(0, np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)))
    unit_max = np.zeros(n_units, dtype=np.uint8)
    nz = lens > 0
    if nz.any():
        unit_max[nz] = np.maximum.reduceat(cat, offs[:-1][nz])
    clump_of = np.arange(n_units, dtype=np.int64) // VECSZ
    pure_unit = unit_max <= 4
    pure_clump = np.ones(tot_rc, dtype=bool)
    np.logical_and.at(pure_clump, clump_of, pure_unit)
    # pure-clump badness: the literal tsum walk reduces to the window
    # count (asum stays 0), threshold per _clump_is_bad
    full_size = (1 << 31) - 1 if k > 14 else 1 << 24
    wins = np.maximum(lens - (k - 1), 0)
    cwins = np.zeros(tot_rc, dtype=np.int64)
    np.add.at(cwins, clump_of, wins)
    bad_pure = pure_clump & (cwins >= full_size)
    if skip_ambig:
        bad_pure[:] = False

    ok_pure = pure_clump & ~bad_pure
    usel = ok_pure[clump_of] & (lens >= k)

    # mixed clumps: literal reference logic (expansion, budget)
    bad: list[int] = []
    mixed_words: dict[int, np.ndarray] = {}
    for c in np.nonzero(~pure_clump)[0]:
        begin, end = c * VECSZ, min(n_units, (c + 1) * VECSZ)
        seqs = [_unit_kseq(rd, p) for p in range(begin, end)]
        if not skip_ambig and _clump_is_bad(seqs, k, z):
            bad.append(int(c))
            continue
        words = np.unique(_clump_words(seqs, k, z,
                                       skip_ambig).astype(np.int64))
        if words.size:
            mixed_words[int(c)] = words
    all_bad = np.sort(np.concatenate(
        [np.nonzero(bad_pure)[0].astype(np.int64),
         np.array(bad, dtype=np.int64)])).astype(np.uint32)

    # native two-pass build (no O(total-windows) key sort; see
    # native.accel_build_native) -- output is identical to the numpy
    # unique()-based path below, which remains as the fallback
    from .native import accel_build_native
    moffs = np.zeros(tot_rc + 1, dtype=np.int64)
    for c, w in mixed_words.items():
        moffs[c + 1] = len(w)
    np.cumsum(moffs, out=moffs)
    mwords = (np.concatenate([mixed_words[c]
                              for c in sorted(mixed_words)])
              if mixed_words else np.zeros(0, dtype=np.int64))
    cu_counts = np.bincount(clump_of[usel], minlength=tot_rc) \
        if usel.any() else np.zeros(tot_rc, dtype=np.int64)
    cu_offs = np.zeros(tot_rc + 1, dtype=np.int64)
    np.cumsum(cu_counts, out=cu_offs[1:])
    res = accel_build_native(
        cat if usel.all()                # no 2x-catbytes temporaries
        else (cat[np.repeat(usel, lens)] if usel.any()
              else np.zeros(0, np.uint8)),
        np.concatenate(([0], np.cumsum(lens[usel]))), cu_offs,
        mwords, moffs, tot_rc, k)
    if res is not None:
        nzw, cnt, ids = res
        return Accelerator(k, SparseCSR(nzw, cnt, ids), all_bad, z)

    # numpy fallback: keys pack WORD-major (word * n_sources + source):
    # one unique() lands directly in CSR layout -- per-word postings
    # ascend by clump, exactly the serialized .acx order -- with no
    # second sort
    key_parts: list[np.ndarray] = []
    if usel.any():
        psel = np.nonzero(usel)[0]
        pcat = cat[np.repeat(usel, lens)]
        plen = lens[psel]
        uid = np.repeat(np.arange(len(psel), dtype=np.int64), plen)
        nwin = len(pcat) - k + 1
        if nwin > 0:
            valid = uid[:nwin] == uid[k - 1:]
            cm1 = pcat.astype(np.int64) - 1
            words = np.zeros(nwin, dtype=np.int64)
            for t in range(k):
                words += cm1[t: t + nwin] << np.int64(2 * (k - 1 - t))
            wsel = np.nonzero(valid)[0]
            key_parts.append(words[wsel] * np.int64(tot_rc)
                             + clump_of[psel[uid[wsel]]])
    for c, words in mixed_words.items():
        key_parts.append(words * np.int64(tot_rc) + np.int64(c))
    if not key_parts:
        z0 = np.zeros(0, dtype=np.int64)
        return Accelerator(k, SparseCSR(z0, z0,
                                        np.zeros(0, dtype=np.uint32)),
                           all_bad, z)
    keys = np.unique(np.concatenate(key_parts))
    return Accelerator(k, _csr_from_word_major(keys, tot_rc), all_bad,
                       z)


def _csr_from_word_major(keys: np.ndarray, n_sources: int) -> SparseCSR:
    """SparseCSR from unique word-major keys (word*n_sources + src)."""
    all_w = keys // np.int64(n_sources)
    ids = (keys % np.int64(n_sources)).astype(np.uint32)
    head = np.empty(len(all_w), dtype=bool)
    head[0] = True
    np.not_equal(all_w[1:], all_w[:-1], out=head[1:])
    starts = np.nonzero(head)[0]
    cnt = np.diff(np.concatenate((starts, [len(all_w)])))
    return SparseCSR(all_w[head], cnt.astype(np.int64), ids)


def build_unit_index(rd: RefData, acc: "Accelerator",
                     skip_ambig: bool = False):
    """Unit-granular postings for the sound per-unit prefilter.

    Same word semantics as the clump index (ambiguity expansion, z
    skipping) but ids are sorted-unit positions, so the q-gram
    pigeonhole bound (burst.c:4091-4095) can be applied per unit: a
    unit with edit distance <= err must share > len - (err+1)*k words,
    so filtering lanes below the bound provably never drops a winner.
    Units of BadList clumps are not indexed (callers must always pass
    them). Cached on `acc`; never serialized (derived data).
    """
    if acc.u_csr is not None:
        return
    k, z = acc.k, acc.z
    n_units = rd.tot_units
    bad_clump = np.zeros(n_units // VECSZ + 1, dtype=bool)
    if len(acc.bad):
        bad_clump[acc.bad.astype(np.int64)] = True
    lens = _unit_lens(rd)
    elig = (~bad_clump[np.arange(n_units) // VECSZ]) & (lens >= k)

    key_parts: list[np.ndarray] = []
    span = np.int64(1) << np.int64(2 * k)

    # native two-pass build: rows are unit positions, so the same
    # counting-sort kernel as the clump index yields unit-granular
    # postings without the O(total-windows) word array (which alone is
    # ~8 bytes/bp -- unbuildable on a multi-GB database)
    ue = np.nonzero(elig)[0]
    if len(ue) and (z or skip_ambig) and k <= 15:
        from .native import accel_build_native
        cat = np.concatenate([_unit_kseq(rd, p) for p in ue]) \
            if len(ue) else np.zeros(0, np.uint8)
        ulen = lens[ue].astype(np.int64)
        offs = np.zeros(len(ue) + 1, dtype=np.int64)
        np.cumsum(ulen, out=offs[1:])
        umax = np.zeros(len(ue), dtype=np.uint8)
        nz = ulen > 0
        if nz.any():
            umax[nz] = np.maximum.reduceat(cat, offs[:-1][nz])
        pure = umax <= 4
        mixed_words: dict[int, np.ndarray] = {}
        for j in np.nonzero(~pure)[0]:
            words = _clump_words([cat[offs[j]: offs[j + 1]]], k, z,
                                 skip_ambig)
            if words.size:
                mixed_words[int(ue[j])] = np.unique(
                    words.astype(np.int64))
        moffs = np.zeros(n_units + 1, dtype=np.int64)
        for p, w in mixed_words.items():
            moffs[p + 1] = len(w)
        np.cumsum(moffs, out=moffs)
        mwords = (np.concatenate([mixed_words[p]
                                  for p in sorted(mixed_words)])
                  if mixed_words else np.zeros(0, dtype=np.int64))
        pcnt = np.zeros(n_units, dtype=np.int64)
        pcnt[ue[pure]] = 1
        cu_offs = np.zeros(n_units + 1, dtype=np.int64)
        np.cumsum(pcnt, out=cu_offs[1:])
        cat_pure = cat[np.repeat(pure, ulen)] if not pure.all() else cat
        offs_pure = np.zeros(int(pure.sum()) + 1, dtype=np.int64)
        np.cumsum(ulen[pure], out=offs_pure[1:])
        res = accel_build_native(cat_pure, offs_pure, cu_offs, mwords,
                                 moffs, n_units, k)
        if res is not None:
            nzw, cnt, ids = res
            acc.u_csr = SparseCSR(nzw, cnt, ids)
            return

    # fast vectorized path (z or skip_ambig: windows with the skip code
    # are dropped; remaining ambiguous windows are DFS-expanded below)
    if len(ue) and (z or skip_ambig):
        cat = np.concatenate([_unit_kseq(rd, p) for p in ue])
        ulen = lens[ue]
        uid = np.repeat(np.arange(len(ue), dtype=np.int64), ulen)
        nwin = len(cat) - k + 1
        if nwin > 0:
            valid = uid[:nwin] == uid[k - 1:]
            c = cat.astype(np.int64)
            skip_hit = (c >= 5) if skip_ambig else (c == 5)
            amb_hit = c > 4 + z
            csk = np.concatenate(([0], np.cumsum(skip_hit)))
            cam = np.concatenate(([0], np.cumsum(amb_hit)))
            w_skip = (csk[k:] - csk[:-k]) > 0          # [nwin]
            w_amb = (cam[k:] - cam[:-k]) > 0
            clear = valid & ~w_skip & ~w_amb
            words = np.zeros(nwin, dtype=np.int64)
            cm1 = c - 1
            for t in range(k):
                words += cm1[t: t + nwin] << np.int64(2 * (k - 1 - t))
            wsel = np.nonzero(clear)[0]
            key_parts.append(words[wsel] * np.int64(n_units)
                             + ue[uid[wsel]])
            # ambiguous (non-skip) windows: DFS expansion, few
            asel = np.nonzero(valid & ~w_skip & w_amb)[0]
            for j0 in asel:
                tmp: list[int] = []
                _expand_words(cat, int(j0), k, tmp)
                if tmp:
                    key_parts.append(
                        np.array(tmp, dtype=np.int64)
                        * np.int64(n_units) + np.int64(ue[uid[j0]]))
    elif len(ue):
        # z=0 without skip_ambig: per-unit reference-semantics fallback
        for p in ue:
            words = _clump_words([_unit_kseq(rd, p)], k, z, skip_ambig)
            if words.size:
                key_parts.append(words * np.int64(n_units)
                                 + np.int64(p))

    if key_parts:
        # word-major keys: one unique() lands in CSR layout (per-word
        # unit postings ascending), no second sort
        keys = np.unique(np.concatenate(key_parts))
        acc.u_csr = _csr_from_word_major(keys, n_units)
    else:
        z0 = np.zeros(0, dtype=np.int64)
        acc.u_csr = SparseCSR(z0, z0, np.zeros(0, dtype=np.uint32))


def make_accelerator(rd: RefData, path: str, z: int = 1,
                     skip_ambig: bool = False, k: int = 15):
    """Build and serialize (the makedb '-a' flow, burst.c:5127-5132)."""
    acc = build_accelerator(rd, k=k, z=z, skip_ambig=skip_ambig)
    tot_rc = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    write_acx(path, acc, tot_rc)
    return acc


# ---------------------------------------------------------------- file io

ACC_VERSION = 0
ACC_VERSION_BIG = 1


def write_acx(path: str, acc: Accelerator, tot_rc: int):
    """Byte-compatible .acx writer (burst.c:3499-3530)."""
    big = tot_rc > 1048574
    with open(path, "wb") as f:
        vers = (1 << 7) | (int(bool(acc.z)) << 6) | \
            (ACC_VERSION_BIG if big else ACC_VERSION)
        f.write(bytes([vers]))
        f.write(np.uint32(len(acc.bad)).tobytes())
        csr = acc.csr
        n_words = 1 << (2 * acc.k)
        # dense counts table: calloc'd zeros + sparse scatter, so only
        # the nonzero pages are ever faulted before the streaming write
        lens_dense = np.zeros(n_words, dtype=np.uint32)
        if len(csr.nzw):
            lens_dense[csr.nzw] = csr.cnt.astype(np.uint32)
        lens_dense.tofile(f)
        del lens_dense
        ids = csr.ids.astype(np.uint64)
        if big:
            # 3 bytes per id; per-word order is already contiguous in CSR
            b = np.zeros((len(ids), 3), dtype=np.uint8)
            b[:, 0] = ids & 0xFF
            b[:, 1] = (ids >> 8) & 0xFF
            b[:, 2] = (ids >> 16) & 0xFF
            b.tofile(f)
        else:
            # vectorized SMALL encode (inverse of read_acx's decode):
            # per word, len//2 5-byte pair records + optional 3-byte
            # tail. All bookkeeping runs on the sparse nonzero words.
            pairs_nz = csr.cnt >> 1
            odd_nz = csr.cnt & 1
            blen_nz = pairs_nz * 5 + odd_nz * 3
            bs_nz = np.concatenate(([0], np.cumsum(blen_nz)))
            out = np.zeros(int(bs_nz[-1]), dtype=np.uint8)
            n_pairs = int(pairs_nz.sum())
            if n_pairs:
                pm = pairs_nz > 0
                ppw = pairs_nz[pm]
                within = np.arange(n_pairs) - np.repeat(
                    np.concatenate(([0], np.cumsum(ppw)[:-1])), ppw)
                src = np.repeat(csr.start[pm], ppw) + 2 * within
                bay = ids[src] | (ids[src + 1] << np.uint64(20))
                rec = np.repeat(bs_nz[:-1][pm], ppw) + 5 * within
                for t in range(5):
                    out[rec + t] = ((bay >> np.uint64(8 * t))
                                    & np.uint64(0xFF)).astype(np.uint8)
            om = odd_nz > 0
            if om.any():
                v = ids[csr.start[om] + csr.cnt[om] - 1]
                rec = bs_nz[:-1][om] + 5 * pairs_nz[om]
                for t in range(3):
                    out[rec + t] = ((v >> np.uint64(8 * t))
                                    & np.uint64(0xFF)).astype(np.uint8)
            out.tofile(f)
        acc.bad.astype(np.uint32).tofile(f)


def _stream_nonzero_lens(f, n_words: int):
    """Stream the dense counts table; return sparse (nz_words, counts)."""
    nz_parts, cnt_parts = [], []
    CH = 1 << 24
    base = 0
    while base < n_words:
        buf = np.fromfile(f, np.uint32, min(CH, n_words - base))
        idx = np.nonzero(buf)[0]
        if idx.size:
            nz_parts.append((base + idx).astype(np.int64))
            cnt_parts.append(buf[idx].astype(np.int64))
        base += len(buf)
    if nz_parts:
        return np.concatenate(nz_parts), np.concatenate(cnt_parts)
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


def read_acx(path: str, k: int | None = None, z_required: int = 1,
             clump_range: tuple[int, int] | None = None
             ) -> Accelerator:
    """Read a .acx (ours or the reference's; SMALL or LARGE format).

    The 4^k counts table is streamed in chunks and kept sparse; only
    the nonzero words survive in memory (see SparseCSR).

    clump_range=(c_lo, c_hi): per-host shard loading -- postings are
    filtered to clump IDs in the range (the decode streams the full
    file once; only the local postings survive in memory). The BadList
    stays global: its second pass is replayed identically on every
    host and filtered to local units at pair expansion.
    """
    import os
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(5)
        cb = head[0]
        ver = cb & 0xF
        did_z = (cb >> 6) & 1
        if cb < 128 or ver not in (ACC_VERSION, ACC_VERSION_BIG):
            raise ValueError(f"ERROR: invalid accelerator [{cb}:{ver}]")
        if did_z and not z_required:
            raise ValueError("ERROR: Accelerator built without '-y'; "
                             "can't use '-y'")
        bad_sz = int(np.frombuffer(head, np.uint32, 1, 1)[0])
        kk_list = [k] if k is not None else [16, 15, 14, 13, 12, 11, 10]
        nzw = cnt = None
        for kk in kk_list:
            hdr = 5 + 4 * (1 << (2 * kk))
            if fsize < hdr:
                continue
            f.seek(5)
            nzw, cnt = _stream_nonzero_lens(f, 1 << (2 * kk))
            if ver == ACC_VERSION_BIG:
                need = int(cnt.sum()) * 3
            else:
                need = int(((cnt >> 1) * 5 + (cnt & 1) * 3).sum())
            if hdr + need + 4 * bad_sz == fsize:
                k = kk
                break
            nzw = cnt = None
        if nzw is None:
            raise ValueError("cannot infer accelerator k")
        total = int(cnt.sum())
        start = np.concatenate(([0], np.cumsum(cnt)[:-1])).astype(np.int64) \
            if len(cnt) else np.zeros(0, np.int64)
        ids = np.zeros(total, dtype=np.uint32)
        if ver == ACC_VERSION_BIG:
            raw = np.fromfile(f, np.uint8, total * 3
                              ).reshape(total, 3).astype(np.uint32)
            ids = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        else:
            # vectorized SMALL decode on the sparse nonzero words: per
            # word, len//2 5-byte pair records + optional 3-byte tail
            pairs_nz = cnt >> 1
            odd_nz = cnt & 1
            blen_nz = pairs_nz * 5 + odd_nz * 3
            bs_nz = np.concatenate(([0], np.cumsum(blen_nz)))
            raw = np.fromfile(f, np.uint8, int(bs_nz[-1]))
            n_pairs = int(pairs_nz.sum())
            if n_pairs:
                pm = pairs_nz > 0
                ppw = pairs_nz[pm]
                within = np.arange(n_pairs) - np.repeat(
                    np.concatenate(([0], np.cumsum(ppw)[:-1])), ppw)
                rec = np.repeat(bs_nz[:-1][pm], ppw) + 5 * within
                b0 = raw[rec].astype(np.uint64)
                b1 = raw[rec + 1].astype(np.uint64)
                b2 = raw[rec + 2].astype(np.uint64)
                b3 = raw[rec + 3].astype(np.uint64)
                b4 = raw[rec + 4].astype(np.uint64)
                bay = b0 | (b1 << np.uint64(8)) | (b2 << np.uint64(16)) | \
                    (b3 << np.uint64(24)) | (b4 << np.uint64(32))
                dst = np.repeat(start[pm], ppw) + 2 * within
                ids[dst] = (bay & np.uint64(0xFFFFF)).astype(np.uint32)
                ids[dst + 1] = ((bay >> np.uint64(20)) &
                                np.uint64(0xFFFFF)).astype(np.uint32)
            om = odd_nz > 0
            if om.any():
                rec = bs_nz[:-1][om] + 5 * pairs_nz[om]
                v = (raw[rec].astype(np.uint32)
                     | (raw[rec + 1].astype(np.uint32) << 8)
                     | (raw[rec + 2].astype(np.uint32) << 16))
                ids[start[om] + cnt[om] - 1] = v
        bad = np.fromfile(f, np.uint32, bad_sz)
    if clump_range is not None:
        c_lo, c_hi = int(clump_range[0]), int(clump_range[1])
        keep = (ids >= c_lo) & (ids < c_hi)
        wid = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
        cnt = np.bincount(wid[keep], minlength=len(cnt)).astype(np.int64)
        ids = np.ascontiguousarray(ids[keep])
    return Accelerator(k, SparseCSR(nzw, cnt, ids), bad, int(did_z))


# ---------------------------------------------------------------- scour

def query_words(s: np.ndarray, k: int, z: int, ambiguous: bool
                ) -> np.ndarray:
    """k-mer multiset of one query (burst.c:4096-4113).

    Clear queries: every position's word (rolling pack). Ambiguous
    queries: ambiguity-expanded words, skipping N-containing windows
    when z is set.
    """
    n = len(s)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    if not ambiguous:
        b = (s.astype(np.int64) - 1)
        win = np.lib.stride_tricks.sliding_window_view(b, k)
        pw = (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
        return win @ pw
    out: list[int] = []
    j = 0
    while j + k <= n:
        if z:
            w = np.nonzero(s[j:j + k] == 5)[0]
            if w.size:
                j += int(w[0]) + 1
                continue
        tmp: list[int] = []
        _expand_words(s, j, k, tmp)
        out.extend(tmp)
        j += 1
    return np.array(out, dtype=np.int64)


def scour_candidates(acc: Accelerator, words: np.ndarray, n_clumps: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-clump hit counts for one query('s word multiset).

    Returns (clump_ids, counts) for clumps with nonzero hits, in
    first-touch order over ascending word value (matching the
    reference's Cache order). Duplicate words contribute their
    multiplicity (burst.c postScour 'max' of per-query run lengths;
    for a single-query bunch this is the multiplicity).
    """
    if words.size == 0:
        return (np.zeros(0, np.int64),) * 2
    uw, mult = np.unique(words, return_counts=True)
    starts, seg_len = acc.csr.lookup(uw)
    total = int(seg_len.sum())
    if total == 0:
        return (np.zeros(0, np.int64),) * 2
    # flatten postings of all query words
    base = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(seg_len)[:-1])), seg_len)
    flat = base + np.arange(total)
    cl = acc.ids[flat].astype(np.int64)
    wgt = np.repeat(mult, seg_len)
    hits = np.bincount(cl, weights=wgt, minlength=n_clumps).astype(np.int64)
    np.minimum(hits, 0xFFFF, out=hits)
    # first-touch order over ascending word value, then posting order
    _, first = np.unique(cl, return_index=True)
    order = cl[np.sort(first)]
    return order, hits[order]
