"""The plain reference: BURST's optimal search and its BEST and CAPITALIST
rows, worked out again from the generated reference sequences and reads.

It imports neither JAX nor the program, and takes nothing the program
made: no .edx/.acx, no candidate filter, no kernel. It runs on whatever
torch device it is given (the card after the window, the CPU in tests).

What it computes, per read and strand (the read's reverse complement is
the second strand):

* The units. The database is the configuration's references sheared as
  BURST's `-d QUICK` makedb shears them (burst.c:2109-2141): an overlap
  ov = int(float32(max_len_q) / float32(thres)), a stride max(ov,
  rebase_amt), unit j of a reference starting at j * stride while that
  is under len - ov, each unit stride + ov long or to the reference's
  end. Units are numbered reference by reference in input order; the
  lowest number wins BURST's ties.
* The candidates, exactly. A read of n bases with the error budget e =
  min(254, int((float32(1) / thres - 1) * n)) in float32 has e + 1
  disjoint pieces of q = min(32, n // (e + 1)) bases; an alignment with
  at most e edits leaves one of them untouched (an N in the read costs
  1 against every base, so it is an edit). Every exact occurrence of a
  piece, found in a sorted index of every q-mer of the references,
  marks the units overlapping the read's diagonal +- e as candidates.
  No alignment within the budget is missed.
* The DP of every candidate (read strand, unit): the semi-global
  alignment (the whole read, free ends in the unit) that minimises the
  edit distance and, among equal distances, maximises the gaps in the
  query (gap_q: reference bases skipped) -- the order in which BURST's
  rescore compares cells. Its tie rules for the other fields: the
  diagonal wins over the vertical move unless the vertical move has the
  lower score or the same score and more gap_q; along a row the nearest
  column wins a tie; gap_r counts the vertical moves of the path. The
  unit's result is the least score of the last row, the most gap_q
  among those cells, final_pos the last such column, gap_r that of the
  first such column (burst.c's rescore).
* BEST: the read's pods are the candidates within the budget; the row
  is the pod with the least distance, then the most gap_q (the higher
  identity), then the lowest unit.
* CAPITALIST: the pods at the read's least distance, after the
  duplicate hunt (a second pod in one reference whose start lies within
  qlen / 2 of the first is dropped: overlapping units hold one
  alignment twice); each reference's votes are its kept pods over the
  batch's distinct reads; the row is the reference that BURST's winner
  walk picks: the most votes, then the lowest number (headers sort as
  numbers here), except where identical units of several references
  form one deduplicated pod, whose expansion the walk follows to its
  last member (`capitalist_winners`); the taxonomy is the LCA of every
  kept pod's lineage with BURST's TAXACUT tolerance
  (burst.c:4781-4818).
* The row's fields: identity 1 - ed / (qlen + gap_q), alignment length
  qlen + gap_q + gap_r, mismatches ed - gaps, gaps, 1, qlen, start
  final_pos - qlen + gap_r + the unit's offset, end final_pos + offset
  (swapped on the reverse strand), ed, and the read's rank among the
  batch's distinct sequences.

Where BURST's output depends on an order that these rules do not fix
(two strands of one unit tied exactly; the order of a read's pods in a
CAPITALIST walk through identical units), every row that some order
gives is accepted."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ASCII -> code: A C G T = 1..4, N and every other letter 5 (burst.c's
# table for the letters the generator writes)
CODE = np.full(256, 5, dtype=np.uint8)
CODE[list(b"ACGTacgt")] = [1, 2, 3, 4, 1, 2, 3, 4]
RC_CODE = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint8)
CAP = 1023                  # scores past this are dead in every budget
OFF = 1 << 20               # field offset in the row's selection key
M21 = (1 << 21) - 1
DP_CHUNK = 1 << 14          # candidates per DP launch group


def budget(n: int, thres: float) -> int:
    req = np.float32(1.0) / np.float32(thres) - np.float32(1.0)
    return int(min(254, int(req * np.float32(n))))


def identity(ed: int, div: int) -> float:
    return float(np.float32(1.0) - np.float32(ed) / np.float32(div))


@dataclasses.dataclass(order=True)
class Pod:
    unit: int
    rc: bool
    ed: int
    gq: int
    gr: int
    fp: int


class Reference:
    """The configuration's references on `device`, sheared into units."""

    def __init__(self, refs: np.ndarray, cfg: dict, heads: list[bytes],
                 lineages: list[bytes] | None, device):
        self.dev = torch.device(device)
        self.R = torch.from_numpy(refs).to(self.dev)        # codes 0..3
        self.n_refs, self.L = refs.shape
        self.thres = cfg["thres"]
        self.ov = int(np.float32(cfg["max_len_q"]) / np.float32(cfg["thres"]))
        self.stride = max(self.ov, cfg["rebase_amt"])
        self.width = self.stride + self.ov
        self.U = max(1, -(-(self.L - self.ov) // self.stride))
        self.heads = heads
        self.lineages = lineages
        self.index: dict[int, tuple] = {}

    # -- units
    def unit_span(self, u: np.ndarray):
        s = (u % self.U) * self.stride
        return u // self.U, s, np.minimum(self.L - s, self.width)

    def unit_at(self, u: int) -> tuple[int, int, int]:
        """(reference, offset, length) of unit u."""
        s = (u % self.U) * self.stride
        return u // self.U, s, min(self.L - s, self.width)

    def unit_content(self, u: int) -> bytes:
        r, s, n = self.unit_at(u)
        return self.R[r, s:s + n].cpu().numpy().tobytes()

    # -- the q-mer index
    def _index(self, q: int):
        got = self.index.get(q)
        if got is None:
            self.index.clear()          # one index at a time on the card
            n_pos = self.L - q + 1
            key = torch.zeros((self.n_refs, n_pos), dtype=torch.int64,
                              device=self.dev)
            for j in range(q):
                key <<= 2
                key |= self.R[:, j:j + n_pos].long()
            keys, order = torch.sort(key.flatten())
            del key
            got = self.index[q] = (keys, order, n_pos)
        return got

    def _piece_hits(self, q: int, codes: np.ndarray, offs: np.ndarray):
        """Exact occurrences of the pieces codes[i, offs[i]:offs[i]+q]:
        (piece row, reference, position) of each."""
        keys, order, n_pos = self._index(q)
        pk = np.zeros(len(offs), dtype=np.int64)
        for j in range(q):
            pk = (pk << 2) | (codes[np.arange(len(offs)), offs + j]
                              .astype(np.int64) - 1)
        pk_t = torch.from_numpy(pk).to(self.dev)
        lo = torch.searchsorted(keys, pk_t)
        hi = torch.searchsorted(keys, pk_t, right=True)
        cnt = hi - lo
        row = torch.repeat_interleave(
            torch.arange(len(pk), device=self.dev), cnt)
        first = torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt, cnt)
        pos = order[first + torch.arange(len(row), device=self.dev)]
        return (row.cpu().numpy(), (pos // n_pos).cpu().numpy(),
                (pos % n_pos).cpu().numpy())

    def candidates(self, strands: list[np.ndarray], first_piece=False,
                   refs: np.ndarray | None = None):
        """(strand row, unit) pairs, sorted and distinct, for every strand
        (codes 1..5); with `refs`, only the units of those references.
        `first_piece` keeps only the first piece of each strand: a
        heuristic single-seed search (the control), which can miss the
        optimum."""
        by_q: dict[int, list] = {}
        for i, c in enumerate(strands):
            n = len(c)
            e = budget(n, self.thres)
            q = min(32, n // (e + 1))
            for p in range(1 if first_piece else e + 1):
                o = p * q
                if (c[o:o + q] <= 4).all():
                    by_q.setdefault(q, []).append((i, o, e, n))
        rows, units = [], []
        for q, lst in sorted(by_q.items()):
            sid = np.array([t[0] for t in lst])
            offs = np.array([t[1] for t in lst])
            mat = np.zeros((len(lst), max(t[1] for t in lst) + q), np.uint8)
            for j, t in enumerate(lst):
                mat[j, :t[1] + q] = strands[t[0]][:t[1] + q]
            pr, ref, pos = self._piece_hits(q, mat, offs)
            if refs is not None:
                keep = np.isin(ref, refs)
                pr, ref, pos = pr[keep], ref[keep], pos[keep]
            e = np.array([t[2] for t in lst])[pr]
            n = np.array([t[3] for t in lst])[pr]
            a = np.maximum(pos - offs[pr] - e, 0)
            b = np.minimum(pos - offs[pr] + n + e, self.L)
            j0 = np.maximum(0, -(-(a - self.width + 1) // self.stride))
            j1 = np.minimum(self.U - 1, (b - 1) // self.stride)
            span = np.maximum(j1 - j0 + 1, 0)
            k = np.repeat(np.arange(len(pr)), span)
            j = j0[k] + np.arange(len(k)) - np.repeat(
                np.cumsum(span) - span, span)
            rows.append(sid[pr][k])
            units.append(ref[k] * self.U + j)
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        key = np.unique(np.concatenate(rows) * (self.n_refs * self.U)
                        + np.concatenate(units))
        return key // (self.n_refs * self.U), key % (self.n_refs * self.U)

    # -- the DP
    def dp(self, strands: list[np.ndarray], srow: np.ndarray,
           units: np.ndarray) -> np.ndarray:
        """[len(srow), 4] (ed, gap_q, gap_r, final_pos) of each candidate;
        ed is CAP where nothing lies within CAP."""
        out = np.zeros((len(srow), 4), dtype=np.int64)
        lens = np.array([len(strands[i]) for i in srow], dtype=np.int64)
        for n in np.unique(lens):
            sel = np.nonzero(lens == n)[0]
            for c0 in range(0, len(sel), DP_CHUNK):
                part = sel[c0:c0 + DP_CHUNK]
                q = np.stack([strands[i] for i in srow[part]])
                out[part] = self._dp_block(q, units[part])
        return out

    def _dp_block(self, q: np.ndarray, units: np.ndarray) -> np.ndarray:
        dev = self.dev
        B, Y = q.shape
        r, s, ln = self.unit_span(units)
        X = int(ln.max())
        cols = torch.arange(X, device=dev)
        r_t = torch.from_numpy(r).to(dev)
        s_t = torch.from_numpy(s).to(dev)
        ln_t = torch.from_numpy(ln).to(dev)
        idx = (s_t[:, None] + cols).clamp(max=self.L - 1)
        u = self.R[r_t[:, None], idx].long() + 1
        live = cols[None, :] < ln_t[:, None]
        u = torch.where(live, u, 0)                  # pad: no match
        qt = torch.from_numpy(q.astype(np.int64)).to(dev)
        xs = torch.arange(X + 1, device=dev)[None, :]
        sc = torch.zeros((B, X + 1), dtype=torch.int64, device=dev)
        gq = torch.zeros_like(sc)
        gr = torch.zeros_like(sc)
        dead = torch.full((B, X), CAP, dtype=torch.int64, device=dev)
        for y in range(1, Y + 1):
            qc = qt[:, y - 1:y]
            cost = ((u != qc) | (qc > 4)).long()
            sO = torch.where(live, sc[:, :-1] + cost, dead)
            sU = sc[:, 1:] + 1
            gO, gU = gq[:, :-1], gq[:, 1:]
            takeU = (sU < sO) | ((sU == sO) & (gU > gO))
            col0 = torch.full((B, 1), y, dtype=torch.int64, device=dev)
            bs = torch.cat([col0, torch.where(takeU, sU, sO).clamp(max=CAP)],
                           1)
            bg = torch.cat([torch.zeros_like(col0), torch.where(takeU, gU, gO)],
                           1)
            br = torch.cat([col0, torch.where(takeU, gr[:, 1:] + 1,
                                              gr[:, :-1])], 1)
            # along the row: the least (score + distance, then most gap_q
            # + distance), the nearest column on a tie
            key = ((bs - xs + OFF) << 42) | ((M21 - (bg - xs + OFF)) << 21) \
                | (M21 - xs)
            kmin = torch.cummin(key, dim=1).values
            src = M21 - (kmin & M21)
            sc = ((kmin >> 42) - OFF + xs).clamp(max=CAP)
            gq = M21 - ((kmin >> 21) & M21) - OFF + xs
            gr = br.gather(1, src)
        s_last = torch.where(live, sc[:, 1:], CAP + 1)
        best = s_last.min(1).values
        is_min = s_last == best[:, None]
        bg = torch.where(is_min, gq[:, 1:], -1).max(1).values
        is_best = is_min & (gq[:, 1:] == bg[:, None])
        c1 = torch.arange(1, X + 1, device=dev)[None, :]
        first = torch.where(is_best, c1, X + 1).min(1).values
        last = torch.where(is_best, c1, 0).max(1).values
        br_ = gr[:, 1:].gather(1, (first - 1)[:, None])[:, 0]
        return torch.stack([best.clamp(max=CAP), bg, br_, last], 1) \
            .cpu().numpy()

    # -- per read
    def pods(self, reads: list[np.ndarray], first_piece=False):
        """Per read (codes 1..5): (budget, pods within it)."""
        strands = []
        for c in reads:
            strands += [c, RC_CODE[c[::-1]]]
        srow, units = self.candidates(strands, first_piece)
        res = self.dp(strands, srow, units)
        got = [(budget(len(c), self.thres), []) for c in reads]
        for (sr, un, (ed, g, r, fp)) in zip(srow, units, res):
            e, lst = got[sr // 2]
            if ed <= e:
                lst.append(Pod(int(un), bool(sr % 2), int(ed), int(g),
                               int(r), int(fp)))
        return got


# -- rows


def _u32(v: int) -> int:
    return int(v) & 0xFFFFFFFF


def _i32(v: int) -> int:
    v = _u32(v)
    return v - (1 << 32) if v >= (1 << 31) else v


def pod_row(ref: Reference, pod: Pod, qlen: int) -> tuple:
    """The row's fields after the two headers: (identity, al_len,
    mismatches, gaps, qlen, start, end, ed)."""
    _, off, _ = ref.unit_at(pod.unit)
    st = pod.fp - qlen + pod.gr + off
    en = pod.fp + off
    if pod.rc:
        st, en = en, st
    gaps = pod.gq + pod.gr
    return (identity(pod.ed, qlen + pod.gq) * 100.0, _u32(qlen + gaps),
            _u32(pod.ed - gaps), _u32(gaps), _u32(qlen), _i32(st), _u32(en),
            _u32(pod.ed))


def _dupe_start(ref: Reference, pod: Pod, qlen: int) -> int:
    _, off, _ = ref.unit_at(pod.unit)
    return _u32(pod.fp + off if pod.rc else pod.fp - qlen + pod.gr + off)


def kept_pods(ref: Reference, pods: list[Pod], qlen: int) -> list[Pod]:
    """The pods at the least distance after the duplicate hunt: of two
    pods in one reference whose starts lie within qlen / 2, the first
    (lower unit, forward strand first) is kept."""
    if not pods:
        return []
    bm = min(p.ed for p in pods)
    ql2 = qlen >> 1
    kept, seen = [], []
    for p in sorted((p for p in pods if p.ed == bm),
                    key=lambda p: (p.unit, p.rc)):
        st = _dupe_start(ref, p, qlen)
        par = p.unit // ref.U
        if any(r == par and _u32(s + ql2) > st and s < _u32(st + ql2)
               for r, s in seen):
            continue
        seen.append((par, st))
        kept.append(p)
    return kept


def best_rows(ref: Reference, pods: list[Pod], qlen: int) -> list[tuple]:
    """Every row BEST may print for the read (one, unless two strands of
    one unit tie exactly)."""
    if not pods:
        return []
    top = min((p.ed, -p.gq, p.unit) for p in pods)
    return [(ref.heads[p.unit // ref.U],) + pod_row(ref, p, qlen)
            for p in pods if (p.ed, -p.gq, p.unit) == top]


def lca(taxa: list[bytes], taxacut: int) -> bytes:
    """BURST's consensus lineage with TAXACUT discord tolerance: sort the
    lineages, find the deepest level at which a run of at least
    n - n // taxacut of them agree, and print that run's lineage to that
    level (burst.c:4781-4818, its counting of full-prefix strings and
    its empty result where no level agrees)."""
    n = len(taxa)
    if n == 1:
        return taxa[0]
    taxa = sorted(taxa)
    div = [0] * n
    for z in range(1, n):
        a, b = taxa[z - 1], taxa[z]
        x = 0
        while x < min(len(a), len(b)) and a[x] == b[x]:
            x += 1
        d = a[:x].count(b";") + (1 if x == len(a) else 0)
        div[z] = d
    maxdiv = max(div)
    if maxdiv == 0:
        return b""
    cutoff = n - n // taxacut
    st, ed = 0, n
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
    lv -= 1
    if lv <= 0:
        return b""
    parts = taxa[max(ed - 1, 0)].split(b";")
    return b";".join(parts[:lv])


def _walk_pods(ref: Reference, tied: list[Pod]):
    """The tied pods as BURST's CAPITALIST walk sees them: one pod a
    distinct unit content and strand (identical units are one
    deduplicated unit, expanded to every reference that holds it, the
    lowest unit first; process.py's curation, burst.c:2203-2221). Per pod:
    (its highest key, the references that may come last in its
    expansion), a key being (votes, -reference)."""
    groups: dict[tuple, list[int]] = {}
    for p in sorted(tied):
        groups.setdefault((ref.unit_content(p.unit), p.rc), []).append(
            p.unit // ref.U)
    return list(groups.values())


def capitalist_winners(ref: Reference, pods: list[Pod], qlen: int,
                       votes: dict[int, int]) -> set[int]:
    """The references that BURST's CAPITALIST winner walk
    (burst.c:4755-4779) can pick for a read, over every order in which
    its pods may come. The walk takes the first entry, then any entry
    with more votes (or as many and a lower number), and, once an entry
    of a pod has won, every later entry of that pod's expansion. So
    walking a pod P from a winner b gives P's last entry if P's best
    entry beats b, and b otherwise. The pod holding the best entry of
    all always wins when walked, and every pod may come before it; the
    answer is what a chain of pods, each beating the last one's last
    entry, reaches from it. Without identical units that is the
    reference with the most votes, then the lowest number."""
    bm = min(p.ed for p in pods)
    tied = [p for p in pods if p.ed == bm]
    ql2 = qlen >> 1
    starts = [(p.unit // ref.U, _dupe_start(ref, p, qlen)) for p in tied]
    dupes = any(a == c and _u32(b + ql2) > d and b < _u32(d + ql2)
                for i, (a, b) in enumerate(starts)
                for (c, d) in starts[i + 1:])
    walk = _walk_pods(ref, tied)
    if dupes and any(len(g) > 1 for g in walk):
        # which duplicate the hunt drops follows the pods' order and may
        # shorten a pod's expansion: any tied reference may win
        return {r for r, _ in starts}

    def key(r):
        return (votes[r], -r)

    pods_ = []
    for g in walk:
        # the lowest unit comes first; of two the other comes last, of
        # more the curation's order (not redone here) decides
        lasts = g[-1:] if len(g) <= 2 else g[1:]
        pods_.append((max(key(r) for r in g), lasts))
    top = max(k for k, _ in pods_)
    todo = [(j, r) for j, (k, lasts) in enumerate(pods_) if k == top
            for r in lasts]
    seen = set(todo)
    while todo:
        j, r = todo.pop()
        for j2, (k2, lasts) in enumerate(pods_):
            if j2 != j and k2 > key(r):
                for r2 in lasts:
                    if (j2, r2) not in seen:
                        seen.add((j2, r2))
                        todo.append((j2, r2))
    return {r for _, r in seen}


def capitalist_rows(ref: Reference, pods: list[Pod], kept: list[Pod],
                    qlen: int, votes: dict[int, int], taxacut: int
                    ) -> list[tuple]:
    """Every row CAPITALIST may print for a read with these pods (kept:
    after the duplicate hunt), given each reference's votes in the
    batch: a reference that the winner walk can pick
    (`capitalist_winners`), and any of its pods at the least distance
    (overlapping units hold one alignment twice)."""
    if not kept:
        return []
    tax = lca([ref.lineages[p.unit // ref.U] for p in kept], taxacut)
    ok = capitalist_winners(ref, pods, qlen, votes)
    bm = kept[0].ed
    return [(ref.heads[p.unit // ref.U],) + pod_row(ref, p, qlen) + (tax,)
            for p in pods if p.ed == bm and p.unit // ref.U in ok]
