"""Alignment engine: phase-A scan, winner selection, phase-B rescore ->
result pods.

Counterpart of the parts of `burst_tpu.engine` that three paths run: the
direct path (no accelerator; `iter_ed_blocks`, `compute_ed_matrix`,
`compute_ed_select`: every query against every unit through the dense
cross kernel K4), BEST mode with an accelerator at QBUNCH=1
(`accel_scan_fused` and what it reaches: K1 in the fused scour, K2 for
the side pairs, K4 for full-scan rows), and the two-step accelerated
path of the other modes (`accel_candidates`: the device scour at any
QBUNCH into candidate visit lists; `compute_ed_matrix_accel`: their
expanded pairs through K2, full-scan rows through K4). All end in
`rescore_winners` (K3). A raw-byte database (`-x`, `db.xalpha`) takes
256-code Peq tables through K4 and K3; the accelerator indexes none of
its queries, so with one they all go to the full scan. The heuristic cut
(`-hr`) scours on the host at clump level (no unit index) and sends the
unpruned pairs through K2. Host-side numpy logic is carried over unchanged
so that the pods, and so the b6 bytes, are identical; device work is
PyTorch ops plus the hand-written kernels. A database larger than the
card runs under the residency plan of `state.load_db`: K2, K3 and K4
read the buckets it streams through the staging ring, and where it holds
no device tables the batch is scoured on the host (a plan decision, as
in burst_tpu). Reads of any length run: past 16 Myers words (512 bp)
and past 511 DP rows or 1,024 rescore columns each kernel takes its wide
route. There is no fallback that hides the device.
"""
from __future__ import annotations

import collections
import copy
import dataclasses

import numpy as np
import torch

from . import devtime
from .accel import query_words
from .kernels import scour_device
from .kernels.myers import build_peq_dev, words_for
from .kernels.myers_cuda import (cross_geometry, myers_cross, myers_pairs,
                                 sm_count)
from .kernels.rescore import rescore_finalize_host
from .kernels.rescore_cuda import rescore_pairs_gather
from .native import expand_pairs_native, pad_rows_native, scour_native
from .process import QueryData, RefData

VECSZ = 16      # the reference's clump width; defines pod ordering only
A_PAD = 32      # pad columns of phase A's bucket tiles (K2 and K4)
QCHUNK = 2048   # query rows of a K4 block at most (and K3's chunk scale)
CROSS_CTAS_PER_SM = 8           # a K4 launch fills the card from here on
CROSS_BLOCK_BYTES = 16 << 20    # a K4 block's uint8 bytes at most, device
CPU_CROSS_BLOCK_BYTES = 1 << 20  # the same on the CPU (the plain version)


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
    then the BadList); unibins with full[j] set have empty segments and
    are covered by the full scan."""
    flat: np.ndarray
    offs: np.ndarray
    full: np.ndarray
    # sound per-unit prefilter (accel.build_unit_index): pairs of
    # `filtered` unibins are evaluated only if their key is in
    # `pass_keys` or the unit belongs to a BadList clump
    pass_keys: np.ndarray | None = None   # sorted j*tot_units+unit
    filtered: np.ndarray | None = None    # [n] bool
    bad_clump: np.ndarray | None = None   # [n_clumps] bool
    # bunch-level candidate lists (before the member filter), for ANY's
    # inline-order report: bunch g's list is bflat[boffs[g]:boffs[g+1]]
    # followed by the BadList
    bflat: np.ndarray | None = None
    boffs: np.ndarray | None = None
    qbunch: int = 1
    bad_list: np.ndarray | None = None
    # rows the device scour handed to the exact host re-scour for
    # overflowing their slot budget: {"bunch_ov_rows", "member_ov_rows"}
    stats: dict | None = None


@dataclasses.dataclass
class SparseED:
    """Phase-A results over candidate pairs: unibin pj, unit pp, min ED
    pe (<= 255) and the first/last best columns (padded coordinates),
    plus the dense [len(full_rows), tot_units] uint8 block `ed_full` of
    the full-scan unibins `full_rows`. `pending` holds deferred (part,
    [3, B] result) chunks until materialize() fetches them in one go."""
    pj: np.ndarray
    pp: np.ndarray
    pe: np.ndarray | None
    full_rows: np.ndarray
    ed_full: np.ndarray
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
        unknown (full-scan rows have no per-pair column record)."""
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

    def lookup_last(self, juni, refpos, tot_units: int):
        """Last best column per (unibin, unit) winner; -1 if unknown."""
        return self.lookup_cols(juni, refpos, tot_units)[1]


# ------------------------------------------------------------ host shapes

def _bucket_queries(qd: QueryData):
    """Group unibin rows by Myers word count W."""
    buckets: dict[int, list[int]] = {}
    for j, s in enumerate(qd.seqs):
        buckets.setdefault(words_for(len(s)), []).append(j)
    return buckets


def _bucket_units(rd: RefData):
    """Group sorted unit positions by padded tile length.

    A host-range .edx shard (db/edx.read_edx clump_range) sets
    rd.unit_range; units outside it are non-local -- another host owns
    and scans them -- and are skipped here."""
    ur = getattr(rd, "unit_range", None)
    lo, hi = (0, rd.tot_units) if ur is None else ur
    pos = np.arange(lo, min(hi, rd.tot_units), dtype=np.int64)
    lbs = _unit_lb(rd)[pos]
    return {int(lb): pos[lbs == lb] for lb in np.unique(lbs)}


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
    """[tot_units] padded length bucket per sorted position (cached).

    Where rd.unit_range is set (a rank of a multi-host world), the units
    outside it get bucket 0, which holds no tile: another rank owns
    them, so no plan counts their bytes and no bucket uploads them."""
    lbs = getattr(rd, "_unit_lb", None)
    if lbs is None:
        ulen = rd.lens[rd.ix_srt[: rd.tot_units]]
        lbs = (-(-np.maximum(ulen, 1) // granularity) * granularity
               ).astype(np.int64)
        ur = getattr(rd, "unit_range", None)
        if ur is not None:
            lbs[: ur[0]] = 0
            lbs[ur[1]:] = 0
        rd._unit_lb = lbs
    return lbs


def _fill_rows(mat: np.ndarray, rd: RefData, positions: np.ndarray):
    """Copy units (sorted positions) into the zero-padded row matrix
    through the native memcpy, in chunks."""
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
            raise RuntimeError("native host library unavailable")


def _tile_matrix(rd: RefData, lb: int, pad: int, pow2: bool = True):
    """Host [n, lb+pad] padded tile matrix of one length bucket's n
    units (rows padded with zeros to a power of two with `pow2`), and
    its sorted-position -> row map."""
    positions = np.nonzero(_unit_lb(rd) == lb)[0]
    n = len(positions)
    mat = np.zeros((_pow2_ceil(max(1, n)) if pow2 else n, lb + pad),
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


def _stream_stats(qd: QueryData) -> dict:
    """The batch's streaming counts (shared by its row subsets): the
    streamed buckets (lb, pad), K2 slabs, K4 blocks and K3 winner pieces
    uploaded, and the bytes copied host to device."""
    return qd.__dict__.setdefault("_stream", {
        "streamed": set(), "slabs": 0, "blocks": 0, "pieces": 0,
        "h2d_bytes": 0})


def _peq_device(qd: QueryData, W: int, db):
    """(row2local, Peq [pow2 rows, C, W] int32) for the unibin rows of
    Myers word count W, built on the device (C = 16 codes, 256 for
    raw-byte queries); cached on the batch."""
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
                            db.peq_smat(qd), W)
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

PAIR_CHUNK = 1 << 20    # pairs per K2 launch, at most


def _pairs_min_ed(qd: QueryData, db, pj: np.ndarray, pp: np.ndarray):
    """Pairs through K2, bucketed by (W, unit length bucket): the
    two-step path's expanded candidates, the fused path's side branch
    (ambiguous rows, BadList units, host re-scoured rows) and prepass.
    Returns the deferred [(part, [3, B] device result)] chunks.

    A bucket goes in launches of up to PAIR_CHUNK pairs (padded to a
    power of two under it): the kernel runs one thread per pair, so a
    launch under some 10^5 pairs leaves most of the card's warp
    schedulers idle, and 2^20 pairs bound the [3, B] result and the two
    index uploads at 20 MB a launch. A bucket the residency plan streams
    goes slab by slab (`_pairs_slabs`). Pairs are independent and land
    by `part`, so neither the chunking nor the slabs are part of the
    result."""
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
            row2local, peq_dev = _peq_device(qd, int(W), db)
            prows = row2local[pj[sel]]
            got = db.bucket_tiles(int(lb), A_PAD)
            if got is None:
                pending += _pairs_slabs(qd, db, sel, prows, pp[sel],
                                        int(W), int(lb), peq_dev)
            else:
                pos2row, tiles_dev = got
                pending += _pair_launches(peq_dev, tiles_dev, sel,
                                          prows, pos2row[pp[sel]], int(W))
    return pending


def _pair_launches(peq_dev, tiles_dev, sel, prows, trows, W: int):
    """K2 over the pairs `sel` (Peq rows `prows`, tile rows `trows` of
    `tiles_dev`) in launches of up to PAIR_CHUNK, on the tiles' device
    (the database's, or a mesh shard's); [(part, result)]."""
    dev = tiles_dev.device
    out = []
    for s0 in range(0, len(sel), PAIR_CHUNK):
        part = sel[s0:s0 + PAIR_CHUNK]
        pchunk = _pow2_ceil(len(part))
        pidx = np.zeros(pchunk, np.int32)
        tidx = np.zeros(pchunk, np.int32)
        pidx[: len(part)] = prows[s0:s0 + pchunk]
        tidx[: len(part)] = trows[s0:s0 + pchunk]
        out.append((part, myers_pairs(
            peq_dev, tiles_dev, torch.from_numpy(pidx).to(dev),
            torch.from_numpy(tidx).to(dev), W)))
    return out


def _pairs_slabs(qd: QueryData, db, sel, prows, units, W: int, lb: int,
                 peq_dev):
    """K2 against a bucket the plan streams (the counterpart of
    burst_tpu's `_pairs_slab_stream`): the pairs sorted by tile row
    (stable) and grouped by slab of `db.slab_rows` rows; each slab goes
    through the staging ring, so slab i+1 uploads while K2 scans slab i.
    Tile indices are local to the slab; results stay deferred."""
    tmat, pos2row = db.host_tiles(lb, A_PAD)
    trows = pos2row[units]
    so = np.argsort(trows, kind="stable")
    sel, prows, trows = sel[so], prows[so], trows[so]
    rows = db.slab_rows(lb + A_PAD)
    sids, starts = np.unique(trows // rows, return_index=True)
    ends = np.append(starts[1:], len(trows))
    stats = _stream_stats(qd)
    stats["streamed"].add((lb, A_PAD))
    out = []
    for sid, g0, g1 in zip(sids.tolist(), starts.tolist(), ends.tolist()):
        lo = sid * rows
        with db.ring.staged(tmat[lo:lo + rows], stats) as slab:
            out += _pair_launches(peq_dev, slab, sel[g0:g1],
                                  prows[g0:g1], trows[g0:g1] - lo, W)
        stats["slabs"] += 1
    return out


def cross_blocks(nq: int, nt: int, W: int, sms: int, max_bytes: int
                 ) -> tuple[int, int]:
    """(query rows, tiles) of each K4 launch over a bucket of nq query
    rows of W words and nt unit tiles, on a device of `sms` SMs.

    Rows: the bucket's, at most QCHUNK. Tiles: enough to give the card
    CROSS_CTAS_PER_SM CTAs a SM (K4 runs one CTA per NQ rows x 128
    tiles), up to the whole bucket: the whole bucket where its uint8
    block stays within `max_bytes`, else the bucket split evenly, in
    whole tile groups, into the fewest launches that do. The cap always
    holds: where even the tiles that fill the card would pass it, the
    rows give way (at 132 SMs that takes a cap under a megabyte). A
    launch's width thus follows the card and the query count, not a
    fixed tile block: a few dozen full-scan rows get a whole bucket of
    hundreds of thousands of tiles."""
    rows = max(1, min(nq, QCHUNK))
    _, threads, (_, groups) = cross_geometry(rows, nt, W)
    fill = max(1, min(nt, threads * -(-CROSS_CTAS_PER_SM * sms // groups)))
    rows = max(1, min(rows, max_bytes // fill))
    per = max(fill, max_bytes // rows // threads * threads)
    if nt <= per:
        return rows, max(1, nt)
    n = -(-nt // per)
    return rows, threads * -(-nt // (n * threads))


def _cross_budget(device: torch.device) -> tuple[int, int]:
    """(SMs, block byte cap) that `cross_blocks` plans K4 launches with:
    the card's own, or one SM and a megabyte for the plain version."""
    if device.type == "cuda":
        return sm_count(device), CROSS_BLOCK_BYTES
    return 1, CPU_CROSS_BLOCK_BYTES


def iter_ed_blocks(qd: QueryData, db, max_pending: int = 16):
    """Stream the direct path's phase A through K4: yields (rows, poss,
    block_u8) host tiles of the [numUnibins, tot_units] min-ED matrix
    (clipped to 255) without ever assembling it, in the reference's
    order: W, then unit length bucket, then query block, then tile block,
    the blocks in the shape `cross_blocks` plans for the device.

    The Peq planes and the resident bucket tiles are sliced on the
    device, not uploaded per block; the tiles of a bucket the residency
    plan streams go block by block through the staging ring (a block at
    most one ring slot), uploaded while K4 scans the block before, once
    per query block. K4 writes each block as uint8 clipped at 255 itself.
    Blocks travel in groups of up to `max_pending`, or
    fewer once a group holds the plan's byte cap, and the next group is
    dispatched before the previous one is waited for, so the device
    scans while the host consumes. Both consumers are independent of the
    block shape: `compute_ed_matrix` writes each block into its place,
    and `compute_ed_select` sorts at the end and only ever drops entries
    above a running minimum that never rises."""
    rd = db.rd
    qbuckets = _bucket_queries(qd)
    ubuckets = _bucket_units(rd)
    sms, max_bytes = _cross_budget(db.device)
    pending: list = []
    groups: collections.deque = collections.deque()

    def _flush():
        groups.append(([m for m, _ in pending],
                       devtime.Fetch([b for _, b in pending])))
        pending.clear()

    def _drain():
        metas, handle = groups.popleft()
        for (rws, pss), block in zip(metas, handle.wait()):
            yield rws, pss, block

    nbytes = 0
    stats = _stream_stats(qd)
    for W, rows in sorted(qbuckets.items()):
        rows_a = np.array(rows, dtype=np.int64)
        # the bucket's rows in ascending order are Peq rows 0..len-1
        _, peq_dev = _peq_device(qd, W, db)
        for lb, poss in sorted(ubuckets.items()):
            got = db.bucket_tiles(lb, A_PAD)
            if got is None:
                host_mat, pos2row = db.host_tiles(lb, A_PAD)
                stats["streamed"].add((lb, A_PAD))
            else:
                pos2row, tiles_dev = got
            r0 = int(pos2row[poss[0]])      # the bucket's local run
            qchunk, tchunk = cross_blocks(len(rows_a), len(poss), W, sms,
                                          max_bytes)
            if got is None:
                tchunk = min(tchunk, db.slab_rows(lb + A_PAD))
            for q0 in range(0, len(rows_a), qchunk):
                pq = peq_dev[q0:min(q0 + qchunk, len(rows_a))]
                for t0 in range(0, len(poss), tchunk):
                    nt = min(tchunk, len(poss) - t0)
                    if got is None:
                        with db.ring.staged(host_mat[r0 + t0:r0 + t0 + nt],
                                            stats) as tb:
                            block = myers_cross(pq, tb, W, torch.uint8)
                        stats["blocks"] += 1
                    else:
                        block = myers_cross(
                            pq, tiles_dev[r0 + t0:r0 + t0 + nt], W,
                            torch.uint8)
                    pending.append(((rows_a[q0:q0 + qchunk],
                                     poss[t0:t0 + nt]), block))
                    nbytes += block.numel()
                    if len(pending) >= max_pending or nbytes >= max_bytes:
                        _flush()
                        nbytes = 0
                        if len(groups) > 1:
                            yield from _drain()
    if pending:
        _flush()
    while groups:
        yield from _drain()


@devtime.spanned("burst.pairs")
def compute_ed_matrix(qd: QueryData, db) -> np.ndarray:
    """Phase A: dense [numUnibins, tot_units] uint8 min-ED matrix
    (clipped 255). Used by ANY mode and for the accelerated path's few
    full-scan rows; the other direct modes stream through
    compute_ed_select instead."""
    ed = np.full((len(qd.seqs), db.rd.tot_units), 255, dtype=np.uint8)
    for rws, pss, block in iter_ed_blocks(qd, db):
        ed[np.ix_(rws, pss)] = block
    return ed


@devtime.spanned("burst.pairs")
def compute_ed_select(qd: QueryData, db, mode: str,
                      compact_at: int = 1 << 22):
    """Streamed phase A + winner selection: equal to select_pods(qd, rd,
    compute_ed_matrix(qd, db), mode) with host memory O(numUniq +
    winners + block) instead of the dense matrix (burst.c:4318-4521's
    running-budget sweep as a running minimum over streamed blocks).

    Returns (juni, refpos, eds) in the row-major order the dense nonzero
    scan produces."""
    nu = qd.num_uniq
    budgets = qd.ed
    budj = budgets[qd.six]                       # per unibin row
    cj: list[np.ndarray] = []
    cp: list[np.ndarray] = []
    ce: list[np.ndarray] = []
    n_cand = 0

    def _sorted():
        jj = np.concatenate(cj) if cj else np.zeros(0, np.int64)
        pp = np.concatenate(cp) if cp else np.zeros(0, np.int64)
        ee = np.concatenate(ce) if ce else np.zeros(0, np.int64)
        return jj, pp, ee

    if mode == "FORAGE":
        for rws, pss, block in iter_ed_blocks(qd, db):
            r, c = np.nonzero(block <= budj[rws][:, None])
            cj.append(rws[r])
            cp.append(pss[c])
            ce.append(block[r, c].astype(np.int64))
        jj, pp, ee = _sorted()
        srt = np.lexsort((pp, jj))
        return jj[srt], pp[srt], ee[srt]

    # tie modes: running per-unique minimum (strand-folded via six)
    best = np.full(nu, 255, dtype=np.int64)

    def _compact():
        nonlocal n_cand
        kept_j, kept_p, kept_e = [], [], []
        for j, p, e in zip(cj, cp, ce):
            k = e == best[qd.six[j]]
            kept_j.append(j[k])
            kept_p.append(p[k])
            kept_e.append(e[k])
        cj[:], cp[:], ce[:] = kept_j, kept_p, kept_e
        n_cand = sum(len(j) for j in cj)

    for rws, pss, block in iter_ed_blocks(qd, db):
        sixb = qd.six[rws]
        # keep entries at or under the running min BEFORE this block
        # tightens it: new-min entries survive, stale ones compact away
        cap = np.minimum(budj[rws], best[sixb])
        r, c = np.nonzero(block <= cap[:, None])
        if len(r):
            cj.append(rws[r])
            cp.append(pss[c])
            ce.append(block[r, c].astype(np.int64))
            n_cand += len(r)
        np.minimum.at(best, sixb, block.min(axis=1).astype(np.int64))
        if n_cand > compact_at:
            _compact()
    _compact()
    valid = best <= budgets
    jj, pp, ee = _sorted()
    k = valid[qd.six[jj]]
    jj, pp, ee = jj[k], pp[k], ee[k]
    srt = np.lexsort((pp, jj))
    return jj[srt], pp[srt], ee[srt]


def select_pods(qd: QueryData, rd: RefData, ed, mode: str):
    """Apply budgets and tie selection; return winner (juni, refpos, ed).

    `ed` is either the dense [numUnibins, tot_units] matrix or a
    SparseED from the accel path (selection then runs on the sparse pair
    arrays and the dense block of its full-scan rows)."""
    nu = qd.num_uniq
    budgets = qd.ed  # [numUniq]
    if isinstance(ed, SparseED):
        ed.materialize()
        pj, pp, pe = ed.pj, ed.pp, ed.pe.astype(np.int64)
        six = qd.six[pj]
        frows = np.asarray(ed.full_rows, dtype=np.int64)
        sub = ed.ed_full
        if mode == "FORAGE":
            keep = pe <= budgets[six]
            out = [(pj[keep], pp[keep], pe[keep])]
            if frows.size:
                mask = sub <= budgets[qd.six[frows]][:, None]
                r, c = np.nonzero(mask)
                out.append((frows[r], c.astype(np.int64),
                            sub[r, c].astype(np.int64)))
        else:
            best = np.full(nu, 255, dtype=np.int64)
            np.minimum.at(best, six, pe)
            if frows.size:
                np.minimum.at(best, qd.six[frows],
                              sub.min(axis=1).astype(np.int64))
            keep = (pe == best[six]) & (pe <= budgets[six])
            out = [(pj[keep], pp[keep], pe[keep])]
            if frows.size:
                fsix = qd.six[frows]
                mask = (sub == best[fsix][:, None]) & \
                    (best[fsix] <= budgets[fsix])[:, None]
                r, c = np.nonzero(mask)
                out.append((frows[r], c.astype(np.int64),
                            sub[r, c].astype(np.int64)))
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]),
                np.concatenate([o[2] for o in out]))
    budj = budgets[qd.six]                   # [nj]
    if mode == "FORAGE":
        maskj = ed <= budj[:, None]
    else:
        # fold strands: per-base-query minimum over its unibin rows
        best = np.full(nu, 255, dtype=np.int64)
        np.minimum.at(best, qd.six, ed.min(axis=1).astype(np.int64))
        valid = best <= budgets
        maskj = (ed == best[qd.six][:, None]) & valid[qd.six][:, None]
    jj, pp = np.nonzero(maskj)
    eds = ed[jj, pp].astype(np.int64)
    return jj.astype(np.int64), pp.astype(np.int64), eds


# ------------------------------------------------------------- phase B

def rescore_pad(lb: int, W: int) -> int:
    """Pad columns of the rescore's bucket tiles: lb + 32W rounded up to
    a multiple of 64, so the wildcard tail rows always find pads."""
    return -(-(lb + 32 * W) // 64) * 64 - lb


def _rescore_pieces(qd: QueryData, db, got, grp, refpos, lb: int,
                    lp: int):
    """(device tiles, the pairs of `grp` they hold, sorted position ->
    row map) for one (W, length bucket) group of the rescore: the
    resident bucket `got` whole, or where it streams the winner tiles
    (burst_tpu's `_winner_tiles_device`): the group's units only, in
    pieces of one ring slot (ANY's winners can be a whole bucket)."""
    if got is not None:
        pos2row, tiles_dev = got
        yield tiles_dev, grp, lambda pos: pos2row[pos]
        return
    stats = _stream_stats(qd)
    stats["streamed"].add((lb, lp - lb))
    uniq = np.unique(refpos[grp])
    step = db.slab_rows(lp)
    for c0 in range(0, len(uniq), step):
        piece = uniq[c0:c0 + step]
        mat = np.zeros((len(piece), lp), dtype=np.uint8)
        _fill_rows(mat, db.rd, piece)
        with db.ring.staged(mat, stats) as tiles_dev:
            yield (tiles_dev, grp & (refpos >= piece[0]) &
                   (refpos <= piece[-1]),
                   lambda pos, piece=piece: np.searchsorted(piece, pos))
        stats["pieces"] += 1


@devtime.spanned("burst.rescore")
def rescore_winners(qd: QueryData, db, juni, refpos, eds, mode: str,
                    pod_order: np.ndarray | None = None,
                    last0: np.ndarray | None = None,
                    win_cols=None) -> Pods:
    """Phase B through K3: exact (ed, gap_q, gap_r, final_pos, identity)
    for the winner pairs, then the reference's pod ordering (or
    `pod_order`, the accel path's visit-rank ordering).

    `last0` (from SparseED.lookup_cols): zero-ED winners with a known
    last-best column skip the DP (no gaps, identity 1.0, final_pos = that
    column minus the wildcard pad shift).

    `win_cols` (from SparseED.lookup_cols): per-pair (first, last) best
    columns from phase A. Pairs whose tie span fits a narrow window run
    the DP on a [Lw-1]-column slice starting at x0 instead of the whole
    tile -- exact, since every min-ED last-row column and every min-cost
    path reaching one lies inside it. Without them (the direct path)
    every pair runs at full width."""
    rd = db.rd
    n = len(juni)
    gap_q = np.zeros(n, np.int64)
    gap_r = np.zeros(n, np.int64)
    fpos = np.zeros(n, np.int64)
    score = np.zeros(n, np.float32)
    out_ed = np.array(eds, dtype=np.int64)
    # rescore bound: the pair's own ED (tie modes) or the query budget
    # (FORAGE/ANY explore all valid refs: burst.c:4437 'min = Emac')
    if mode in ("FORAGE", "ANY"):
        bound = qd.ed[qd.six[juni]].astype(np.int64)
    else:
        bound = out_ed

    pending = []
    order = np.arange(n)
    _, qlens_all, qw_all = _query_matrix(qd)
    qws = qw_all[juni] if n else np.zeros(0, np.int64)
    lbs = _unit_lb(rd)[refpos] if n else np.zeros(0, np.int64)
    todo = np.ones(n, dtype=bool)
    if last0 is None and win_cols is not None:
        last0 = win_cols[1]
    if last0 is not None and n:
        last0 = np.asarray(last0, dtype=np.int64)
        skip = (out_ed == 0) & (last0 > 0)
        score[skip] = np.float32(1.0)
        fpos[skip] = last0[skip] - (qws[skip] * 32 - qlens_all[juni[skip]])
        todo &= ~skip
    x0_all = np.full(n, -1, dtype=np.int64)
    span_all = np.zeros(n, dtype=np.int64)
    if win_cols is not None and n:
        first_m = np.asarray(win_cols[0], dtype=np.int64)
        last_m = np.asarray(win_cols[1], dtype=np.int64)
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
            got = db.bucket_tiles(int(lb), lp - int(lb))
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
            for tiles_dev, inp, rowmap in _rescore_pieces(
                    qd, db, got, grp, refpos, int(lb), lp):
                for sub, windowed in ((fits & inp, True),
                                      (inp & ~fits, False)):
                    sel = order[sub]
                    if len(sel):
                        _dispatch(sel, W, peq_dev, tiles_dev,
                                  row2local[juni[sel]], rowmap(refpos[sel]),
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

    # Reference pod ordering: single-thread full-path insertion order is
    # (clump asc, query-row asc, lane asc) head-inserted, i.e. iteration
    # order (clump desc, query-row desc, lane desc) (burst.c:4343-4477).
    if pod_order is not None:
        srt = pod_order
    else:
        srt = np.lexsort((-(refpos % VECSZ), -juni, -(refpos // VECSZ)))
    return Pods(six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
                ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
                gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


def align(qd: QueryData, db, mode: str) -> Pods:
    """The direct path: streamed phase A + selection, then phase B."""
    juni, refpos, eds = compute_ed_select(qd, db, mode)
    return rescore_winners(qd, db, juni, refpos, eds, mode)


# ------------------------------------------------------------ accel path

def default_qbunch(n: int, threads: int) -> int:
    """QBUNCH = newUniqQ/(threads*128), clamped to [1, 16]
    (burst.c:4019-4021)."""
    qbunch = n // (max(1, threads) * 128)
    return max(1, min(16, qbunch))


def bunch_thresholds(qd: QueryData, b1: int, k: int, qbunch: int,
                     do_heur: bool = False):
    """Pigeonhole thresholds per unibin/bunch (burst.c:4091-4095,
    4163-4168): returns (mm_bunch, mm_inner, n_bunches). The heuristic
    cut (`do_heur`, -hr) raises a member's candidate floor to
    len/16 + 1 hits."""
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    errs = qd.ed[qd.six[:b1]].astype(np.int64)
    kload = errs * k + k
    mm_member = np.where(kload < lns, lns - kload, 0)
    if do_heur:
        mm_member = np.maximum(mm_member, (lns >> 4) + 1)
    mm_inner = np.where(kload < lns, lns - kload, 1)
    n_bunches = (b1 + qbunch - 1) // qbunch
    mm_bunch = np.full(n_bunches, 1 << 60, dtype=np.int64)
    if b1:
        np.minimum.at(mm_bunch, np.arange(b1) // qbunch, mm_member)
    return mm_bunch, mm_inner, n_bunches


def _clear_row_words(qd: QueryData, r0: int, r1: int, k: int,
                     qidx_parts: list, word_parts: list) -> None:
    """Rolling k-mer words of the clear (pure-ACGT) unibin rows
    [r0, r1), appended as (row-index, word) column pairs."""
    if r1 <= r0:
        return
    qmat, qlens_all, _ = _query_matrix(qd)
    clear = np.arange(r0, r1)
    lens_c = qlens_all[clear]
    pw = (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    for ln in np.unique(lens_c):
        rows = clear[lens_c == ln]
        if ln < k:
            continue
        sub = qmat[rows, :ln].astype(np.int64) - 1
        nwin = ln - k + 1
        words = np.zeros((len(rows), nwin), dtype=np.int64)
        for t in range(k):                       # k passes, no 3-D temp
            words += sub[:, t: t + nwin] * pw[t]
        qidx_parts.append(np.repeat(rows, nwin))
        word_parts.append(words.ravel())


@devtime.spanned("burst.scour.words")
def _bunch_words_padded(qd: QueryData, r0: int, b1: int, qbunch: int,
                        k: int):
    """Per-bunch deduped word lists with MAX-multiplicity weights for
    the fully-clear bunches covering rows [r0, b1) (the reference's
    shared bunch scour, burst.c:4096-4119), packed left into
    (wmat [nB, T] int32, wgt [nB, T] int32, nwords [nB]) -- or None
    when no row yields a word."""
    qp, wp = [], []
    _clear_row_words(qd, r0, b1, k, qp, wp)
    if not qp:
        return None
    qidx = np.concatenate(qp)
    words = np.concatenate(wp)
    span = np.int64(1) << np.int64(2 * k)
    ukey, mult = np.unique(qidx * span + words, return_counts=True)
    ub = (ukey // span - r0) // qbunch
    uw = ukey % span
    bkey = ub * span + uw
    bso = np.argsort(bkey, kind="stable")
    bks = bkey[bso]
    bhead = np.empty(len(bks), dtype=bool)
    bhead[0] = True
    np.not_equal(bks[1:], bks[:-1], out=bhead[1:])
    bgid = np.cumsum(bhead) - 1
    bmax = np.zeros(int(bgid[-1]) + 1, dtype=np.int64)
    np.maximum.at(bmax, bgid, mult[bso])
    gw = (bks[bhead] % span).astype(np.int64)
    gb = (bks[bhead] // span).astype(np.int64)
    nB = -(-(b1 - r0) // qbunch)
    nwords = np.bincount(gb, minlength=nB).astype(np.int32)
    T = int(nwords.max())
    wmat = np.zeros((nB, T), dtype=np.int32)
    wgt = np.ones((nB, T), dtype=np.int32)
    col = np.arange(len(gw)) - np.repeat(
        np.concatenate(([0], np.cumsum(nwords)))[:-1].astype(np.int64),
        nwords)
    wmat[gb, col] = gw.astype(np.int32)
    wgt[gb, col] = np.minimum(bmax, 0x7FFFFFFF).astype(np.int32)
    return wmat, wgt, nwords


# The numpy scour pass: burst_tpu's host scour in three steps, the
# multi-host merge's building block (`parallel.multihost`). It touches no
# device; on one card the native or device scour runs instead.

@devtime.spanned("burst.scour.words")
def bunch_word_multiset(qd: QueryData, acc, b0: int, b1: int,
                        qbunch: int, k: int):
    """Per-(bunch, word) k-mer multiset of the accelerator-eligible
    unibins (burst.c:4096-4119): returns (bwords, bb, bmax, uq, uw,
    mult) -- the deduped bunch word list with MAX-multiplicity weights,
    plus the per-(unibin, word) multiset behind it -- or None when no
    unibin yields a word. Depends only on the (replicated) queries, so
    every DB-shard host computes the identical list."""
    qidx_parts, word_parts = [], []
    # ambiguous unibins: per-query expansion (few)
    for j in range(b0):
        words = query_words(qd.seqs[j], k, acc.z, ambiguous=True)
        if words.size:
            qidx_parts.append(np.full(words.size, j, dtype=np.int64))
            word_parts.append(words)
    # clear unibins: vectorized rolling k-mers, grouped by length
    _clear_row_words(qd, b0, b1, k, qidx_parts, word_parts)
    if not qidx_parts:
        return None
    qidx = np.concatenate(qidx_parts)
    words = np.concatenate(word_parts)
    span = np.int64(1) << np.int64(2 * k)
    ukey, mult = np.unique(qidx * span + words, return_counts=True)
    uq = ukey // span
    uw = ukey % span
    # per (bunch, word): weight = MAX multiplicity over bunch members
    if qbunch == 1:
        bwords, bb, bmax = uw, uq, mult.astype(np.int64)
    else:
        ub = uq // qbunch
        bkey = ub * span + uw
        bso = np.argsort(bkey, kind="stable")
        bks = bkey[bso]
        bhead = np.empty(len(bks), dtype=bool)
        bhead[0] = True
        np.not_equal(bks[1:], bks[:-1], out=bhead[1:])
        bgid = np.cumsum(bhead) - 1
        bmax = np.zeros(int(bgid[-1]) + 1, dtype=np.int64)
        np.maximum.at(bmax, bgid, mult[bso])
        bwords = (bks[bhead] % span).astype(np.int64)
        bb = (bks[bhead] // span).astype(np.int64)
    return bwords, bb, bmax, uq, uw, mult


def scour_raw(acc, bwords, bb, bmax, n_clumps: int):
    """Scour acc's postings for the bunch word list: per-candidate
    (bunch, clump, hits, first-word) tuples, or None when no posting
    matches. `acc` may be a per-host shard (postings filtered to a
    clump range): candidates for a clump are computed entirely on the
    host owning it, so concatenating per-host results reproduces the
    single-process candidate set exactly."""
    starts, seg = acc.csr.lookup(bwords)
    total = int(seg.sum())
    if total == 0:
        return None
    base = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(seg)[:-1])), seg)
    flat = base + np.arange(total)
    cl = acc.ids[flat].astype(np.int64)
    brep = np.repeat(bb, seg)
    wgt = np.repeat(bmax, seg)
    wrd = np.repeat(bwords, seg)
    pkey = brep * n_clumps + cl
    # group-by via one stable argsort (first occurrence = group head)
    so = np.argsort(pkey, kind="stable")
    ps = pkey[so]
    head = np.empty(len(ps), dtype=bool)
    head[0] = True
    np.not_equal(ps[1:], ps[:-1], out=head[1:])
    u2 = ps[head]
    gid = np.cumsum(head) - 1
    hits = np.bincount(gid, weights=wgt[so].astype(np.float64)
                       ).astype(np.int64)
    first = so[np.nonzero(head)[0]]
    np.minimum(hits, 0xFFFF, out=hits)
    pb = (u2 // n_clumps).astype(np.int64)   # bunch id per candidate
    pc = (u2 % n_clumps).astype(np.int64)
    # first-occurrence k-mer of each candidate: the scour stream walks
    # words ascending per bunch with clump-ascending postings, so
    # ordering by (fw, clump) equals ordering by stream position -- and
    # unlike the position it is comparable across per-host shards
    fw = wrd[first]
    return pb, pc, hits, fw


def assemble_accel_visits(n: int, b0: int, b1: int, qbunch: int,
                          n_bunches: int, bad_arr, full,
                          pb, pc, hits, fw, mm_bunch,
                          mm_inner) -> Visits:
    """Candidate tuples -> Visits: pigeonhole filter, reference visit
    order (hits desc, first-occurrence asc; burst.c:4120-4130), member
    expansion with the per-member inner skip, BadList append. Pure
    host-side assembly shared by the single-process path and the
    multi-host merge (which concatenates per-host scour_raw results
    first)."""
    nb = len(bad_arr)
    keep = hits > mm_bunch[pb]
    kb = pb[keep]
    srt = np.lexsort((pc[keep], fw[keep], -hits[keep], kb))
    kb = kb[srt]
    kc = pc[keep][srt]
    kh = hits[keep][srt]
    # expand bunch candidate lists to members, applying the per-member
    # inner skip (bunch hits vs the member's threshold)
    cands_per_b = np.bincount(kb, minlength=n_bunches)
    bstart = np.concatenate(([0], np.cumsum(cands_per_b)))
    memb = np.arange(b1)
    mb = memb // qbunch
    reps = cands_per_b[mb]
    mrep = np.repeat(memb, reps)                 # member per expanded cand
    total_e = int(reps.sum())
    csr = np.concatenate(([0], np.cumsum(reps)))[:-1]
    src = (np.arange(total_e) - np.repeat(csr, reps)
           + np.repeat(bstart[mb], reps))
    kc_m = kc[src]
    ok = kh[src] > mm_inner[mrep]
    mrep, kc_m = mrep[ok], kc_m[ok]
    cands_per_q = np.bincount(mrep, minlength=b1)
    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1: b1 + 1] = np.cumsum(cands_per_q + nb)
    offs[b1 + 1:] = offs[b1]
    out = np.empty(int(offs[b1]), dtype=np.int64)
    csum = np.concatenate(([0], np.cumsum(cands_per_q)))
    out[offs[mrep] + (np.arange(len(mrep)) - csum[mrep])] = kc_m
    if nb:
        dst = (offs[:b1, None] + cands_per_q[:, None] +
               np.arange(nb)[None, :]).ravel()
        out[dst] = np.tile(bad_arr, b1)
    boffs = np.zeros(n_bunches + 1, dtype=np.int64)
    boffs[1:] = np.cumsum(cands_per_b)
    return Visits(flat=out, offs=offs, full=full, bflat=kc, boffs=boffs,
                  qbunch=qbunch, bad_list=bad_arr)


@devtime.spanned("burst.scour")
def accel_candidates(qd: QueryData, db, qbins: np.ndarray,
                     do_heur: bool = False, threads: int = 1,
                     qbunch: int | None = None,
                     skip_ambig: bool = False,
                     dev_scour: bool | None = None) -> Visits:
    """Per-unibin candidate visit lists, from the device scour.

    The reference scans QBUNCH unibins per task (burst.c:4018-4021,
    QBUNCH = newUniqQ/(threads*128) clamped to [1,16]): the bunch
    shares one scour -- per word the count contribution is the MAX
    multiplicity across the bunch (postScour's run logic,
    burst.c:3258-3284) -- one candidate list filtered by the bunch's
    minimum threshold, and one visit order. The per-member threshold
    only skips evaluations (burst.c:4163-4168). Thread count changes
    QBUNCH and therefore row order; -t 1 is the canonical comparison.

    The heuristic cut (`do_heur`, -hr) raises the bunch floor and turns
    the unit index off, as in burst_tpu: the batch is scoured by the
    native scour at clump level, and the visits carry no per-unit
    prefilter (every lane of a visited clump is a pair).

    `dev_scour=False` sends this batch to the native scour as well
    (`Aligner.align_batch`'s per-batch choice); True or None follows the
    plan. Where the native scour ran, `stats["scour"]` says so."""
    rd, acc = db.rd, db.acc
    db.check_alphabet(qd)
    k = acc.k
    n = len(qd.seqs)
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    b0, b1 = int(qbins[0]), int(qbins[1])
    full = np.ones(n, dtype=bool)
    full[:b1] = False
    if skip_ambig:
        # -sa at align time: BadList second pass and the full-scan
        # rows are both skipped; bad-bin unibins drop silently
        # (burst.c:4047, 4322)
        bad_arr = bad_arr[:0]
        full[:] = False
    if qbunch is None:
        qbunch = default_qbunch(n, threads)
    mm_bunch, mm_inner, _ = bunch_thresholds(qd, b1, k, qbunch, do_heur)
    qmat, qlens_all, _ = _query_matrix(qd)
    aq_off, aqw, aqm = _ambig_word_lists(qd, b0, k, acc.z)
    if not len(aqw) and not (b1 > b0 and
                             bool((qlens_all[b0:b1] >= k).any())):
        # no row has a word: every list is the BadList alone
        nb = len(bad_arr)
        offs = np.zeros(n + 1, dtype=np.int64)
        offs[1: b1 + 1] = np.arange(1, b1 + 1) * nb
        offs[b1 + 1:] = b1 * nb
        return Visits(flat=np.tile(bad_arr, b1), offs=offs, full=full)
    native = db.tabs is None or do_heur or dev_scour is False
    if native:
        # the whole batch through the native scour, as burst_tpu's
        # `_accel_candidates_native` does: where the residency plan holds
        # no device tables, under -hr, which has no unit index, and where
        # the caller asks for the host scour
        res = _native_scour(qmat, qlens_all, b0, b1, qbunch, k, aq_off,
                            aqw, aqm, acc.csr, n_clumps, mm_bunch,
                            mm_inner,
                            u_csr=None if do_heur else acc.u_csr,
                            tot_units=rd.tot_units, vecsz=VECSZ)
        info = {}
    else:
        scour = _scour_device_rows if qbunch == 1 else \
            _scour_device_bunches
        res, info = scour(qd, db, b0, b1, qbunch, k, mm_bunch, mm_inner,
                          qmat, qlens_all, aq_off, aqw, aqm, n_clumps)
    vis = _assemble_visits(qd, res, b0, b1, qbunch, bad_arr, full,
                           n_clumps, do_unit=not do_heur)
    vis.stats = {key: info.get(key, 0)
                 for key in ("bunch_ov_rows", "member_ov_rows")}
    if native:
        vis.stats["scour"] = "native"
    return vis


def _assemble_visits(qd, res, b0: int, b1: int, qbunch: int, bad_arr,
                     full, n_clumps: int, do_unit: bool = True) -> Visits:
    """Visits CSR from a scour result tuple (bflat, bhits, bcnt, mflat,
    mcnt, ukeys), shared by the two-step and the fused path. Without
    `do_unit` (-hr: no unit index) the visits carry no per-unit
    prefilter."""
    n = len(qd.seqs)
    nb = len(bad_arr)
    kc, _, bcnt, mflat, mcnt, ukeys = res

    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1: b1 + 1] = np.cumsum(mcnt + nb)
    offs[b1 + 1:] = offs[b1]
    out = np.empty(int(offs[b1]), dtype=np.int64)
    nm = len(mflat)
    if nm != int(mcnt.sum()):
        raise RuntimeError(
            f"scour result inconsistent: len(mflat)={nm} != "
            f"sum(mcnt)={int(mcnt.sum())} -- concurrent scour calls "
            "sharing one result buffer?")
    if nm:
        csum = np.concatenate(([0], np.cumsum(mcnt)[:-1]))
        dst = np.repeat(offs[:b1], mcnt) + \
            (np.arange(nm) - np.repeat(csum, mcnt))
        out[dst] = mflat
    if nb:
        dstb = (offs[:b1, None] + mcnt[:, None] +
                np.arange(nb)[None, :]).ravel()
        out[dstb] = np.tile(bad_arr, b1)
    n_bunches = (b1 + qbunch - 1) // qbunch
    boffs = np.zeros(n_bunches + 1, dtype=np.int64)
    boffs[1:] = np.cumsum(bcnt)
    vis = Visits(flat=out, offs=offs, full=full, bflat=kc, boffs=boffs,
                 qbunch=qbunch, bad_list=bad_arr)
    if do_unit:
        vis.pass_keys = ukeys
        vis.filtered = np.zeros(n, dtype=bool)
        vis.filtered[b0:b1] = True
        vis.bad_clump = np.zeros(n_clumps, dtype=bool)
        vis.bad_clump[bad_arr] = True
    return vis


@devtime.spanned("burst.scour.words")
def _ambig_word_lists(qd, b0: int, k: int, z: int):
    """Ambiguous unibins' expanded unique words + multiplicities."""
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


def _native_scour(*args, **kw):
    """scour_native, which the path cannot do without."""
    res = scour_native(*args, **kw)
    if res is None:
        raise RuntimeError("native host library unavailable")
    return res


def _scour_device_rows(qd, db, b0, b1, qbunch, k, mm_bunch, mm_inner,
                       qmat, qlens_all, aq_off, aqw, aqm, n_clumps,
                       fused_W: int | None = None):
    """Clear rows [b0, b1) through the device scour at QBUNCH=1, merged
    with a host scour of the ambiguous rows [0, b0). Returns the native
    scour's (bflat, bhits, bcnt, mflat, mcnt, ukeys) tuple -- the bunch
    candidates with their hit counts, the member candidates and the
    passing unit keys, in the native walk's order -- and an info dict
    with the overflowed rows (`ov_rows`, global, and their count
    `member_ov_rows`). With `fused_W` the
    scour runs fused with K1 at that word count, and info also carries
    the clear rows' device-aligned pairs.

    Rows over the slot budget E (`ov`) are re-scoured exactly on the
    host by the native scour and spliced back -- part of the algorithm,
    not a fallback: the device slot matrix is fixed-width."""
    if qbunch != 1:
        raise ValueError("one row per query is the QBUNCH=1 scour")
    acc = db.acc
    tot_units = db.rd.tot_units
    z = np.zeros(0, np.int64)
    nc = max(0, b1 - b0)
    lens_c = qlens_all[b0:b1]
    mm_m = mm_bunch[b0:b1]             # qbunch == 1: bunch == member
    mm_i = mm_inner[b0:b1]
    fetch = None
    if nc and fused_W is not None:
        fetch = scour_device.scour_align_rows(
            qmat[b0:b1], lens_c, k, mm_m, mm_i, db.tabs, tot_units,
            db.smat_dev, db.tiles_packed, fused_W)
        _inject_device_peq(qd, b0, b1, fused_W, db, fetch)
    elif nc:
        fetch = scour_device.scour_rows(
            qmat[b0:b1], lens_c, k, mm_m, mm_i, db.tabs, tot_units)
    # ambiguous rows on the host while the device runs
    amb = (z, z, z, z, z, z)
    if b0 > 0:
        amb = _native_scour(qmat, qlens_all, b0, b0, 1, k, aq_off, aqw,
                            aqm, acc.csr, n_clumps, mm_bunch[:b0],
                            mm_inner[:b0], u_csr=acc.u_csr,
                            tot_units=tot_units, vecsz=VECSZ)
    if fetch is None:
        return amb, {}
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
        sbf, sbh, sbc, _, _, suk = _native_scour(
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
    bcnt_c = np.bincount(lj, minlength=nc).astype(np.int64)
    mkeep = chits > mm_i[lj]
    mcnt_c = np.bincount(lj[mkeep], minlength=nc).astype(np.int64)
    ukeys_c = dev["ukeys"] + np.int64(b0) * tot_units
    if ov.any():
        keepu = ~ov[dev["ukeys"] // tot_units]
        ukeys_c = np.sort(np.concatenate(
            [ukeys_c[keepu], suk_g + np.int64(b0) * tot_units]))
    abf, abh, abc, amf, amc, auk = amb
    res = (np.concatenate([abf, lcl]), np.concatenate([abh, chits]),
           np.concatenate([abc, bcnt_c]),
           np.concatenate([amf, lcl[mkeep]]), np.concatenate([amc, mcnt_c]),
           np.concatenate([auk, ukeys_c]))
    info = {"ov_rows": np.nonzero(ov)[0] + b0,
            "member_ov_rows": int(ov.sum())}
    if fused_W is not None:
        info.update(
            uj=dev["uj"] + b0,         # global unibin rows
            uu=dev["uu"],
            packed=np.stack([dev["ped"], dev["pfirst"], dev["plast"]]))
    return res, info


def _scour_device_bunches(qd, db, b0, b1, qbunch, k, mm_bunch, mm_inner,
                          qmat, qlens_all, aq_off, aqw, aqm, n_clumps):
    """QBUNCH>1 device scour: two overlapped dispatches reproduce the
    native bunch walk bit for bit (burst.c:4018-4136 at the reference's
    default QBUNCH up to 16).

    Dispatch A (scour_bunch_rows): one row per fully-clear bunch,
    deduped words weighted by MAX member multiplicity -> the bunch
    candidate clump lists. Dispatch B (scour_rows with the clump
    filter saturated): one row per member -> the exact per-member
    passing unit keys. Bunches containing ambiguous rows (the sorted
    prefix [0, ceil(b0/qbunch)*qbunch)) run on the host C++ scour
    while both device dispatches are in flight. Overflowing bunch rows
    re-scour on the host candidates-only; overflowing member rows
    re-run the host unit prefilter; both splice exactly. Returns the
    native scour's result tuple and the counts of both kinds of
    overflowed rows."""
    acc = db.acc
    tot_units = db.rd.tot_units
    g0 = -(-b0 // qbunch)              # first fully-clear bunch
    r0 = min(g0 * qbunch, b1)
    z = np.zeros(0, np.int64)
    zb = np.zeros(1, np.int64)
    bwp = _bunch_words_padded(qd, r0, b1, qbunch, k)
    fetch_b = fetch_m = None
    if bwp is not None:
        wmat, wgt, nwords = bwp
        nB = wmat.shape[0]
        nm = b1 - r0
        fetch_b = scour_device.scour_bunch_rows(
            wmat, wgt, nwords, mm_bunch[g0:],
            np.full(nB, 1 << 60, np.int64),       # no unit winners
            db.tabs, tot_units)
        fetch_m = scour_device.scour_rows(
            qmat[r0:b1], qlens_all[r0:b1], k,
            np.full(nm, 1 << 60, np.int64),       # no clump winners
            mm_inner[r0:b1], db.tabs, tot_units)
    # ambiguous rows + the straddling bunch on the host meanwhile; with
    # no word in the clear bunches, they too (empty lists)
    pre = (z, z, z, z, z, z)
    h1 = r0 if bwp is not None else b1
    if h1 > 0:
        pre = _native_scour(qmat, qlens_all, b0, h1, qbunch, k, aq_off,
                            aqw, aqm, acc.csr, n_clumps,
                            mm_bunch[: -(-h1 // qbunch)], mm_inner[:h1],
                            u_csr=acc.u_csr, tot_units=tot_units,
                            vecsz=VECSZ)
    if bwp is None:
        return pre, {}
    dev_b = fetch_b()
    dev_m = fetch_m()
    abf, abh, abc, amf, amc, auk = pre

    # bunch candidates: splice host re-scours of overflowed bunches
    gj, gcl = dev_b["cj"], dev_b["ccl"]
    ghits, gminw = dev_b["chits"], dev_b["cminw"]
    ovb = dev_b["ov"]
    if ovb.any():
        keep = ~ovb[gj]
        aj, acl, ah, amw = [gj[keep]], [gcl[keep]], [ghits[keep]], \
            [gminw[keep]]
        for bg in np.nonzero(ovb)[0]:
            j_lo = r0 + int(bg) * qbunch
            j_hi = min(b1, j_lo + qbunch)
            sbf, sbh = _native_scour(
                np.ascontiguousarray(qmat[j_lo:j_hi]),
                qlens_all[j_lo:j_hi], 0, j_hi - j_lo, qbunch, k,
                np.zeros(j_hi - j_lo + 1, np.int64), zb, zb, acc.csr,
                n_clumps, mm_bunch[g0 + bg: g0 + bg + 1],
                mm_inner[j_lo:j_hi])[:2]
            aj.append(np.full(len(sbf), bg, np.int64))
            acl.append(sbf)
            ah.append(sbh)
            # native rank encoded below the device minw range keeps
            # the (hits desc, touch asc) order through the lexsort
            amw.append(-(1 << 40) + np.arange(len(sbf), dtype=np.int64))
        gj, gcl = np.concatenate(aj), np.concatenate(acl)
        ghits, gminw = np.concatenate(ah), np.concatenate(amw)
    srt = np.lexsort((gcl, gminw, -ghits, gj))
    gj, gcl, ghits = gj[srt], gcl[srt], ghits[srt]
    bcnt_dev = np.bincount(gj, minlength=nB).astype(np.int64)

    # member expansion with the per-member inner skip (burst.c:4163-68)
    bstart = np.concatenate(([0], np.cumsum(bcnt_dev)))
    members = np.arange(r0, b1, dtype=np.int64)
    mb = (members - r0) // qbunch
    reps = bcnt_dev[mb]
    mrep = np.repeat(members, reps)
    total_e = int(reps.sum())
    csr0 = np.concatenate(([0], np.cumsum(reps)))[:-1]
    src = (np.arange(total_e, dtype=np.int64) - np.repeat(csr0, reps)
           + np.repeat(bstart[mb], reps))
    okm = ghits[src] > mm_inner[mrep]
    mflat_dev = gcl[src][okm]
    mcnt_dev = np.bincount(mrep[okm] - r0, minlength=nm).astype(np.int64)

    # member-exact unit keys; overflowed member rows re-run on host
    ovm = dev_m["ov"]
    uk = dev_m["ukeys"]
    if ovm.any():
        extra = [uk[~ovm[uk // tot_units]]]
        for lr in np.nonzero(ovm)[0]:
            j = r0 + int(lr)
            suk = _native_scour(
                np.ascontiguousarray(qmat[j: j + 1]), qlens_all[j: j + 1],
                0, 1, 1, k, np.zeros(2, np.int64), zb, zb, acc.csr,
                n_clumps, np.full(1, 1 << 60, np.int64),
                mm_inner[j: j + 1], u_csr=acc.u_csr, tot_units=tot_units,
                vecsz=VECSZ)[5]
            extra.append(np.int64(lr) * tot_units + suk)
        uk = np.sort(np.concatenate(extra))
    res = (np.concatenate([abf, gcl]), np.concatenate([abh, ghits]),
           np.concatenate([abc, bcnt_dev]),
           np.concatenate([amf, mflat_dev]),
           np.concatenate([amc, mcnt_dev]),
           np.concatenate([auk, uk + np.int64(r0) * tot_units]))
    return res, {"bunch_ov_rows": int(ovb.sum()),
                 "member_ov_rows": int(ovm.sum())}


def accel_scan_fused(qd: QueryData, db, qbins: np.ndarray, qbunch: int,
                     skip_ambig: bool = False,
                     dev_scour: bool | None = None):
    """Fused accelerator scan (QBUNCH=1): device scour + K1 over the
    clear rows in one dispatch chain; ambiguous rows, BadList units and
    rows the device overflowed go through K2; full-scan rows (reads the
    accelerator cannot index) against every unit through K4. Returns
    (visits, sed, stats) with stats counting the overflowed rows, the
    full-scan rows and the pairs of each branch, and QBUNCH (1) -- or
    None, as in
    burst_tpu, where the caller runs the two-step path: unless the
    caller's QBUNCH (`qbunch`, burst.c:4019-4021) is 1; on a raw-byte
    database (`-x`); for a batch without a clear row of length >= k,
    which has nothing to fuse; and where the residency plan holds no
    packed store or no device tables (which includes unit postings that
    are not clump-grouped); and where the caller asks for the host scour
    (`dev_scour=False`). `skip_ambig` (-sa at align time) drops the
    BadList pass and the full-scan rows, as the two-step path does."""
    rd, acc = db.rd, db.acc
    n = len(qd.seqs)
    db.check_alphabet(qd)
    if qbunch != 1 or db.xalpha or dev_scour is False:
        return None
    if db.tiles_packed is None or db.tabs is None:
        return None
    k = acc.k
    b0, b1 = int(qbins[0]), int(qbins[1])
    qmat, qlens_all, qw_all = _query_matrix(qd)
    if b1 <= b0 or not bool((qlens_all[b0:b1] >= k).any()):
        return None
    W = int(qw_all[:b1].max())
    tot_units = rd.tot_units
    n_clumps = tot_units // VECSZ + (1 if tot_units % VECSZ else 0)
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    errs = qd.ed[qd.six[:b1]].astype(np.int64)
    kload = errs * k + k
    mm_bunch = np.where(kload < lns, lns - kload, 0)
    mm_inner = np.where(kload < lns, lns - kload, 1)
    # the scour with its fused K1, and the visits it gives
    with devtime.span("burst.scour"):
        aq_off, aqw, aqm = _ambig_word_lists(qd, b0, k, acc.z)
        res, pinfo = _scour_device_rows(
            qd, db, b0, b1, 1, k, mm_bunch, mm_inner, qmat, qlens_all,
            aq_off, aqw, aqm, n_clumps, fused_W=W)
        full = np.ones(n, dtype=bool)
        full[:b1] = False
        if skip_ambig:
            bad_arr = bad_arr[:0]
            full[:] = False
        vis = _assemble_visits(qd, res, b0, b1, 1, bad_arr, full,
                               n_clumps)

    with devtime.span("burst.pairs"):
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
            units_b = (bad_arr[:, None] * VECSZ
                       + np.arange(VECSZ)).ravel()
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
        full_rows, ed_full = _full_scan_rows(qd, db, vis)
    sed = SparseED(pj=pj, pp=pp, pe=None, full_rows=full_rows,
                   ed_full=ed_full, pending=pending)
    stats = {"ov_rows": len(pinfo["ov_rows"]), "side_pairs": nh,
             "dev_pairs": len(pinfo["uj"]), "full_rows": len(full_rows),
             "qbunch": 1}
    return vis, sed, stats


def _full_scan_rows(qd: QueryData, db, visits: Visits):
    """(rows, [len(rows), tot_units] uint8 min-ED block) of the unibins
    the accelerator cannot index, every unit scanned through K4."""
    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        return full_rows, compute_ed_matrix(_subset_qd(qd, full_rows), db)
    return full_rows, np.zeros((0, db.rd.tot_units), dtype=np.uint8)


@devtime.spanned("burst.pairs")
def compute_ed_matrix_accel(qd: QueryData, db, visits: Visits) -> SparseED:
    """Phase A of the two-step path over candidate pairs only (sparse,
    through K2), and the full scan for the rows the accelerator cannot
    index (K4). The pair chunks are only dispatched: materialize() (or
    select_pods, which calls it) fetches them, so the caller's host work
    overlaps the device scan."""
    full_rows, ed_full = _full_scan_rows(qd, db, visits)
    pj, pp = expand_visit_pairs(qd, db.rd, visits)
    if not len(pj):
        return SparseED(pj=pj, pp=pp, pe=np.zeros(0, dtype=np.int64),
                        full_rows=full_rows, ed_full=ed_full)
    return SparseED(pj=pj, pp=pp, pe=None, full_rows=full_rows,
                    ed_full=ed_full,
                    pending=_pairs_min_ed(qd, db, pj, pp))


def expand_visit_pairs(qd: QueryData, rd: RefData, visits: Visits):
    """Expand visit clump lists into (unibin, unit) pair arrays, with
    the sound lane-level pruning applied (see Visits.pass_keys)."""
    pruned = visits.pass_keys is not None
    got = expand_pairs_native(
        visits.offs, visits.flat, len(qd.seqs), rd.tot_units, VECSZ,
        visits.filtered if pruned else None,
        visits.bad_clump if pruned else None, visits.pass_keys)
    if got is None:
        raise RuntimeError("native host library unavailable")
    return got


def densify(sed: SparseED, nj: int, tot_units: int) -> np.ndarray:
    """Dense [nj, tot_units] matrix from SparseED (unevaluated = 255)."""
    sed.materialize()
    ed = np.full((nj, tot_units), 255, dtype=np.uint8)
    if len(sed.full_rows):
        ed[sed.full_rows] = sed.ed_full
    if len(sed.pj):
        ed[sed.pj, sed.pp] = sed.pe.astype(np.uint8)
    return ed


def _subset_qd(qd: QueryData, rows: np.ndarray) -> QueryData:
    """The batch restricted to unibin `rows`. The row-indexed caches
    refer to the parent's numbering, so the query matrix is sliced and
    the Peq cache dropped (it rebuilds on demand)."""
    _stream_stats(qd)                   # shared with the subset
    sub = copy.copy(qd)
    sub.seqs = [qd.seqs[j] for j in rows]
    sub.six = qd.six[rows]
    sub.rc = qd.rc[rows]
    cached = sub.__dict__.pop("_qmat", None)
    sub.__dict__.pop("_peq_torch", None)
    if cached is not None:
        sub._qmat = tuple(c[rows] for c in cached)
    return sub


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
    pod_full = visits.full[juni]
    rank[pod_full] = -1 - clump[pod_full]  # full-path: clump desc == rank asc
    acc_ix = np.nonzero(~pod_full)[0]
    if acc_ix.size:
        key = juni[acc_ix] * n_clumps + clump[acc_ix]
        rank[acc_ix] = vrank_s[np.searchsorted(vkey_s, key)]
    lane = refpos % VECSZ
    is_rc = qd.rc[juni].astype(np.int64)
    # full-path pods (rank < 0) keep full-path ordering among themselves;
    # they belong to bad-bin queries, disjoint from accel queries
    full_mask = rank < 0
    keys_full = np.lexsort((-lane[full_mask], -juni[full_mask],
                            rank[full_mask]))
    keys_acc = np.lexsort((-lane[~full_mask], -rank[~full_mask],
                           is_rc[~full_mask], qd.six[juni[~full_mask]]))
    idx_full = np.nonzero(full_mask)[0][keys_full]
    idx_acc = np.nonzero(~full_mask)[0][keys_acc]
    return np.concatenate([idx_acc, idx_full])
