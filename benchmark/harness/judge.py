"""`correct`: the rows the timed path printed for a sample of the window's
reads, held field by field against the plain reference's.

One number is compared: `rows_wrong`, the sampled reads whose rows
differ from every row the reference allows (a row missing, a row where
none is due, or any field different), with the limit 0. Integer fields
and names must be equal; the identity, which the program prints as
float32 times 100 with six decimals, may differ by IDENTITY_TOL
percentage points (13 float32 steps at 100; one gap more or less moves
a 292-base read's identity by 0.00117 points at least).

The control puts the reference in the program's place with its
guarantee broken: a single-seed search (the first piece of each read
only, as a heuristic aligner seeds), which misses optimal hits."""
from __future__ import annotations

import numpy as np

from . import reference as refmod

IDENTITY_TOL = 1e-4


def sample(rng: np.random.Generator, done: list[int], n_reads: int,
           traffic: dict, n: int) -> list[tuple[int, int]]:
    """(batch, read) pairs: `n` reads spread over every completed batch
    (as many from each, drawn uniformly within it), plus the first short
    read and the first N read of one batch drawn from them."""
    per = max(1, -(-n // len(done)))
    k0 = int(rng.choice(done))
    got = {(k0, traffic["short_first"]), (k0, 0)}
    for k in done:
        got.update((int(k), int(i)) for i in
                   rng.choice(n_reads, size=min(per, n_reads), replace=False))
    return sorted(got)


def parse_b6(data: bytes) -> dict[bytes, list[tuple]]:
    rows: dict[bytes, list[tuple]] = {}
    for line in data.split(b"\n"):
        if not line:
            continue
        c = line.split(b"\t")
        row = (c[1], float(c[2])) + tuple(int(v) for v in c[3:6]) + \
            (int(c[7]), int(c[8]), int(c[9]), int(c[10]))
        rows.setdefault(c[0], []).append(
            (row, c[6], int(c[11]), c[12] if len(c) > 12 else None))
    return rows


def uniq_rank(reads: list[np.ndarray]) -> np.ndarray:
    """Each read's rank among the batch's distinct sequences, ordered as
    zero-padded codes (the program's `last` column)."""
    codes = [refmod.CODE[r] for r in reads]
    w = 32 * max(1, -(-max(len(c) for c in codes) // 32))
    mat = np.zeros((len(codes), w), dtype=np.uint8)
    for j, c in enumerate(codes):
        mat[j, :len(c)] = c
    keys = mat.view(f"S{w}").ravel()
    uk = np.unique(keys)
    return np.searchsorted(uk, keys)


def _same(got, want) -> bool:
    row, one, last, tax = got
    wrow, wlast, wtax = want
    return (one == b"1" and last == wlast and tax == wtax
            and row[0] == wrow[0] and abs(row[1] - wrow[1]) <= IDENTITY_TOL
            and row[2:] == wrow[2:])


def expected_rows(ref: refmod.Reference, traffic: dict, batch,
                  picks: list[int], first_piece=False):
    """read index -> every row the reference allows for it (rows of
    (fields, last, taxonomy)); [] where no row is due."""
    heads, reads = batch
    rank = uniq_rank(reads)
    codes = [refmod.CODE[r] for r in reads]
    got = ref.pods([codes[i] for i in picks], first_piece)
    capitalist = traffic["mode"] == "CAPITALIST"
    want: dict[int, list] = {}
    if not capitalist:
        for i, (_, pods) in zip(picks, got):
            want[i] = [(r, int(rank[i]), None) for r in
                       refmod.best_rows(ref, pods, len(codes[i]))]
        return want
    allp = {i: pods for i, (_, pods) in zip(picks, got)}
    kept = {i: refmod.kept_pods(ref, allp[i], len(codes[i])) for i in picks}
    tied = {p.unit // ref.U for ps in kept.values() for p in ps}
    # the votes of the tied references: every other distinct read of the
    # batch whose candidates reach one of their units
    picked = {int(rank[i]) for i in picks}
    first: dict[int, int] = {}
    for i in range(len(reads)):
        first.setdefault(int(rank[i]), i)
    others = [i for r, i in first.items() if r not in picked]
    strands = []
    for i in others:
        strands += [codes[i], refmod.RC_CODE[codes[i][::-1]]]
    srow, _ = ref.candidates(strands, first_piece,
                             refs=np.fromiter(tied, np.int64, len(tied)))
    near = sorted({others[s // 2] for s in srow})
    voters = {int(rank[i]): kept[i] for i in picks}
    for i, (_, pods) in zip(near, ref.pods([codes[i] for i in near],
                                           first_piece)):
        voters[int(rank[i])] = refmod.kept_pods(ref, pods, len(codes[i]))
    votes = dict.fromkeys(tied, 0)
    for ps in voters.values():
        for p in ps:
            if p.unit // ref.U in votes:
                votes[p.unit // ref.U] += 1
    for i in picks:
        rows = refmod.capitalist_rows(ref, allp[i], kept[i], len(codes[i]),
                                      votes, traffic["taxacut"])
        want[i] = [(r[:-1], int(rank[i]), r[-1]) for r in rows]
    return want


def judge(ref: refmod.Reference, traffic: dict, batches, outputs: dict,
          picks: list[tuple[int, int]], control=False) -> dict:
    """Compare the rows of the sampled reads. `outputs[k]` is batch k's
    b6 bytes; with `control`, the control's rows stand in its place."""
    wrong = 0
    detail = []
    by_batch: dict[int, list[int]] = {}
    for k, i in picks:
        by_batch.setdefault(k, []).append(i)
    for k, idx in sorted(by_batch.items()):
        heads = batches[k][0]
        want = expected_rows(ref, traffic, batches[k], idx)
        if control:
            alt = expected_rows(ref, traffic, batches[k], idx,
                                first_piece=True)
            rows = {heads[i]: [(w[0], b"1", w[1], w[2]) for w in alt[i][:1]]
                    for i in idx}
        else:
            rows = parse_b6(outputs[k])
        for i in idx:
            got = rows.get(heads[i], [])
            ok = (len(got) == (1 if want[i] else 0) and
                  all(any(_same(g, w) for w in want[i]) for g in got))
            if not ok:
                wrong += 1
                if len(detail) < 3:
                    detail.append((heads[i].decode(), got[:1], want[i][:1]))
    return dict(rows_wrong=wrong, reads_checked=len(picks), detail=detail)
