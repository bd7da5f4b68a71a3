"""Database and read generation, from a configuration and a traffic file.

Copies of `chip_smoke.make_workload` (chip_smoke.py:2647-2678, after
bench.py:84-108) and `make_amplicon_workload` (chip_smoke.py:3394-3428,
after bench.py:179-208), with the N and short-read edits of
`accel_workload` and `twostep_workload` (chip_smoke.py:2943-2953,
3464-3484). The distributions are theirs; the draws are vectorised (one
call per array instead of a Python loop per member or read), so the
sequences differ from theirs for the same seed.

A database is a fixed part of a deployment and comes from the
configuration's own `db_seed`. Reads come from the run's `--seed`, one
independent stream per batch index, so batch k is the same whenever it
is drawn.
"""
from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# complement of the ASCII letters the generator writes (N stays N)
COMP = np.zeros(256, dtype=np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")


def ref_codes(cfg: dict) -> np.ndarray:
    """The references as codes 0..3 (A, C, G, T), [families * members,
    member_len]: each family one random ancestor, each member the
    ancestor with floor(divergence * member_len) positions redrawn
    uniformly (with replacement)."""
    rng = np.random.default_rng(cfg["db_seed"])
    nf, nm, ln = cfg["families"], cfg["members"], cfg["member_len"]
    n_mut = int(cfg["divergence"] * ln)
    anc = rng.integers(0, 4, size=(nf, ln), dtype=np.uint8)
    refs = np.repeat(anc, nm, axis=0)
    rows = np.repeat(np.arange(nf * nm), n_mut)
    pos = rng.integers(0, ln, size=nf * nm * n_mut)
    refs[rows, pos] = rng.integers(0, 4, size=nf * nm * n_mut,
                                   dtype=np.uint8)
    return refs


def ref_heads(cfg: dict) -> list[bytes]:
    nm = cfg["members"]
    fmt = cfg["head_format"]
    return [fmt.format(f=i // nm, m=i % nm).encode()
            for i in range(cfg["families"] * nm)]


def lineage(cfg: dict, i: int) -> bytes:
    """The 7-level taxonomy of reference i (family f, member m), as
    `make_amplicon_workload` draws it."""
    nm = cfg["members"]
    f, m = i // nm, i % nm
    return cfg["lineage_format"].format(
        p=f % 40, c=f % 160, o=f % 400, fa=f % 800, f=f, m=m).encode()


def batch_rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(k)])


def draw_batch(refs: np.ndarray, traffic: dict, seed: int, k: int):
    """Batch k of a run: (headers, seqs) as `Aligner.align_batch` takes
    them (ASCII uint8 arrays). Reads are cut from a random reference at a
    random offset, get 0..max_subs substitutions (uniform count, uniform
    positions with replacement, uniform letters), are reverse-complemented
    with probability rc_share; then every n_every-th read (from 0) gets
    one N and every short_every-th (from short_first) is cut to
    short_len bases, which is under k: the full-scan rows."""
    rng = batch_rng(seed, k)
    n, ln = traffic["batch_reads"], traffic["read_len"]
    n_refs, rlen = refs.shape
    ri = rng.integers(0, n_refs, n)
    st = rng.integers(0, rlen - ln, n)
    mat = refs[ri[:, None], st[:, None] + np.arange(ln)]
    ns = rng.integers(0, traffic["max_subs"] + 1, n)
    pos = rng.integers(0, ln, (n, traffic["max_subs"]))
    val = rng.integers(0, 4, (n, traffic["max_subs"]), dtype=np.uint8)
    live = np.arange(traffic["max_subs"])[None, :] < ns[:, None]
    rows = np.broadcast_to(np.arange(n)[:, None], pos.shape)
    mat[rows[live], pos[live]] = val[live]
    seqs = ACGT[mat]
    rc = rng.random(n) < traffic["rc_share"]
    seqs[rc] = COMP[seqs[rc, ::-1]]
    nrow = np.arange(0, n, traffic["n_every"])
    seqs[nrow, rng.integers(0, ln, len(nrow))] = ord("N")
    short = set(range(traffic["short_first"], n, traffic["short_every"]))
    sl = traffic["short_len"]
    reads = [seqs[i, :sl] if i in short else seqs[i] for i in range(n)]
    heads = [f"b{k:05d}r{i:06d}".encode() for i in range(n)]
    return heads, reads


class Batches:
    """Batch k of a run drawn once, on first use; `prefetch` draws the
    first ones during set-up."""

    def __init__(self, refs: np.ndarray, traffic: dict, seed: int):
        self.refs, self.traffic, self.seed = refs, traffic, seed
        self.got: dict[int, tuple] = {}

    def __getitem__(self, k: int):
        b = self.got.get(k)
        if b is None:
            b = self.got[k] = draw_batch(self.refs, self.traffic,
                                         self.seed, k)
        return b

    def prefetch(self, n: int):
        for k in range(n):
            self[k]
