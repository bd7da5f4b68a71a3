"""Wrapper of the rescore kernel (`csrc/rescore.cu`, K3) and the
per-chunk gather that feeds it.

`rescore` launches the kernel for CUDA tensors (or raises) and runs
`rescore_plain` for CPU tensors; it counts its launches in its
`launches` attribute, and by route in `routes`: the routes of the row
in registers with packed look-back keys, "warp" (up to 1,024 columns:
one warp a pair, L1 / 32 columns a lane where the look-back window fits
a lane's run, several pairs a CTA), "wide" (one CTA of up to 32 warps a
pair, 8, 16 or 32 columns a thread, a halo between warps) and
"segments" (past what one CTA's registers hold: each pair's row as
overlapping column windows on the warp or wide route, one an item of
the grid, their partial results joined by `rescore_merge`, which counts
its own launches); "cluster" (where a window would be mostly margin:
one thread-block cluster of 2-16 CTAs a pair, the wide route's layout
across them, the halo between CTAs through distributed shared memory;
past what a cluster holds, windows of the cluster's reach and the
merge); "bands" (where even those windows would be mostly margin: the
pair's rows in bands, each band one cluster-route launch over windows
whose margin is the band's cone, not all the rows', each band's last row
stored once in device memory, one row a pair, for the next; the last
band's partial results joined by the merge; one count a band launch);
and "global" (threads striding over the columns, int64 keys, the row
state in a global scratch) only where no other route holds the shape: a
look-back of 1,024 or more past 1,024 columns, or 2^27 columns or more.
`rescore_geometry`, `rescore_segments`, `rescore_cluster` and
`rescore_bands` pick the route and its launch shape in plain Python.
`rescore_pairs_gather` is the counterpart of
`burst_tpu.kernels.rescore.rescore_pairs_gather_async`: it gathers each
pair's Peq row (and tile window) in PyTorch, then calls `rescore`,
which at full width reads the bucket rows by tile index.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import _build
from .myers_cuda import GLOBAL_SCRATCH, sm_count
from .rescore import l1_for, levels_for, rescore_plain, rows_for, \
    window_tiles

SMEM_MAX = 232448 - 1024    # dynamic shared memory a CTA may opt into
GLOBAL_THREADS = 1024       # the global route: threads striding over columns
# the wide route's instances: columns a thread -> the most threads a CTA
# (its launch bound: the register file over the C columns' keys and
# shiftR and a doubling's temporaries)
WIDE_MAX_THREADS = {8: 1024, 16: 768, 32: 576}
WIDE_MAX_HALO = 16   # halo lanes a warp: at least half of it its own
# the warp route's instances: columns a thread (64-bit keys at 32 only);
# pairs a CTA, one a warp (its launch bound), fewer where their tables
# would pass WARP_SMEM
WARP_COLS = (4, 8, 12, 16, 20, 24, 28, 32)
WARP_PAIRS = 4
WARP_SMEM = 48 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
RESCORE_CODES = (16, 256)   # Peq codes, nucleotide or raw byte
# the segment route: a segment owns at least SEG_OWN_SHARE x its margin
# where one CTA's registers allow, else at least a quarter of its window
# (past that the global route); windows of about SEG_WINDOW columns, fewer
# where that leaves under SEG_FILL windows an SM
SEG_OWN_SHARE = 4
SEG_WINDOW = 4096
SEG_FILL = 4
# the cluster route's instances: (columns a thread, key bits) -> the most
# threads a CTA (its launch bound: at 64 bits twice the key words)
CLUSTER_MAX_THREADS = {(8, 32): 1024, (16, 32): 768, (32, 32): 512,
                       (16, 64): 512, (32, 64): 384}
CLUSTER_MAX = 16     # CTAs a cluster where the card grants it (8 portable)
# the planner's cost of a cluster barrier a row, in a scheduler's
# instruction slots (a planning constant, not a measurement)
CLUSTER_BARRIER_CYCLES = 800
# SMs of a GPC, at least, that a cluster's CTAs share (the H100's 132 in
# 8 GPCs): a GPC holds floor(16 x CTAs an SM / K) clusters of K
CLUSTER_GPC_SMS = 16
# absolute columns the segment, cluster and band routes carry (the
# merge's 27-bit fields); past them the global route
COLUMN_LIMIT = 1 << 27
# the band route: the stored rows of one launch (two of 8 bytes a column
# a pair) within this many bytes, half of state.WORKING_SET_RESERVE,
# the pairs in chunks where they would pass it; its planning constants
# (not measurements): a band launch's own cost and the card's bytes a
# cycle (3.35 TB/s at about 1.76 GHz), both in a scheduler's cycles
BAND_ROW_BYTES = 4 << 30
BAND_LAUNCH_CYCLES = 10000
BAND_BYTES_CYCLE = 1900
_SIG = {"rescore_wide_launch": [_P] * 5 + [_I] * 12 + [_P],
        "rescore_seg_launch": [_P] * 5 + [_I] * 18 + [_P],
        "rescore_cluster_launch": [_P] * 5 + [_I] * 17 + [_P],
        "rescore_band_launch": [_P] * 7 + [_I] * 19 + [_P],
        "rescore_cluster_max": [_I] * 4 + [_P],
        "rescore_merge_launch": [_P] * 3 + [_I] * 3 + [_P]}


class RescoreLaunch(NamedTuple):
    """A K3 launch: its route ("warp", "wide", "segments" or "global";
    the cluster and band routes plan a ClusterLaunch), threads per CTA,
    CTAs, dynamic shared-memory bytes (0 on the global route), on the
    register routes the columns a thread and the halo lanes a warp, and
    the pairs a CTA (on the segment route: the window's launch over
    pairs x segments items)."""
    route: str
    threads: int
    grid: int
    smem: int
    cols: int = 0
    halo: int = 0
    pairs: int = 1


class ClusterLaunch(NamedTuple):
    """A K3 launch on the cluster route ("cluster") or the band route
    ("bands"): threads a CTA, CTAs in all (clusters x `cluster`; on the
    band route a band launch's over a chunk of pairs), dynamic
    shared-memory bytes, columns a thread, halo lanes a warp, CTAs a
    cluster, key bits; and the row's split: the DP's L1 of a cluster
    (`window`), the columns each window owns after `margin`, windows a
    pair (`segs`; 1: the whole row, own L1 - 1 and margin 0); on the
    band route the rows a band (`band`) and the pairs a launch
    (`chunk`)."""
    route: str
    threads: int
    grid: int
    smem: int
    cols: int
    halo: int
    cluster: int
    kb: int
    window: int
    own: int
    margin: int
    segs: int
    band: int = 0
    chunk: int = 0


class RescoreSegments(NamedTuple):
    """The segment route's split of a row of L1 columns: windows of
    `window` columns (their DP's L1), each owning `own` columns after a
    margin of `margin`, `segs` of them a pair."""
    window: int
    own: int
    margin: int
    segs: int


def rescore_key_bits(L1: int, levels: int, rows: int = 0, Lg: int = 0
                     ) -> tuple[int, int, int, int]:
    """(score bits, gap_q bits, distance bits, window) of the register
    and cluster routes' look-back key at this shape: a candidate
    projected to the column it is compared at has a score of at most 512
    + w - 1, a gap_q of at most L1 (one more than the column; `Lg` where
    given: a band's window holds the whole row's gap_q) and, with `rows`
    (the cluster and band routes), of at most 1 + (rows - 1)(w - 1)
    (each row's look-back adds under w: csrc/rescore.cu's header), and a
    distance under the window w = min(2^levels, L1); with the bit that
    marks a missing column they take a 32-bit key where they fit 31
    bits, else a 64-bit one."""
    w = L1 if levels >= 30 else min(L1, 1 << levels)
    g = Lg or L1
    if rows > 0:
        g = min(g, 1 + (rows - 1) * (w - 1))
    return (512 + w - 1).bit_length(), (g + 1).bit_length(), \
        (w - 1).bit_length(), w


def rescore_wide_smem(nw: int, halo: int, cols: int, pequ32: int,
                      pairs: int = 1, kb: int = 32) -> int:
    """Dynamic shared memory of a register-route or cluster-route launch
    (`nw` warps a CTA): the halo exchange (two rows of H x C keys of `kb`
    bits and shiftR a warp; a 64-bit key on the register routes runs one
    warp a pair, no halo), the final reduction (20 bytes a warp slot),
    and for each of its pairs the Peq table and one code byte a column
    slot."""
    return 2 * nw * halo * cols * (kb // 8 + 4) + 32 * 20 + \
        pairs * (4 * pequ32 + 32 * nw * cols)


def register_geometry(N: int, L1: int, pequ32: int = 0,
                      levels: int = 1) -> RescoreLaunch | None:
    """The register routes' launch over N rows of L1 columns, or None
    past what one CTA's registers hold (see `rescore_geometry`)."""
    sb, gb, db, w = rescore_key_bits(L1, levels)
    kb = 32 if sb + gb + db <= 31 else 64
    best = None
    for cols in WARP_COLS if sb + gb + db <= 63 else ():
        pow2 = cols & (cols - 1) == 0
        if L1 <= 32 * cols:     # one warp a pair
            if (not pow2 and w > cols) or (kb == 64 and cols != 32):
                continue
            nw, halo = 1, 0
            per = rescore_wide_smem(1, 0, cols, pequ32) - 32 * 20
            pairs = max(1, min(WARP_PAIRS, N, WARP_SMEM // per))
        else:                   # one CTA of warps a pair
            halo = -(-w // cols)
            if cols not in WIDE_MAX_THREADS or kb == 64 or \
                    halo > WIDE_MAX_HALO:
                continue
            nw, pairs = -(-L1 // ((32 - halo) * cols)), 1
            if 32 * nw > WIDE_MAX_THREADS[cols]:
                continue
        smem = rescore_wide_smem(nw, halo, cols, pequ32, pairs)
        if smem > SMEM_MAX:
            continue
        rank = (nw > 1, nw * cols, cols)
        if best is None or rank < best[0]:
            best = rank, RescoreLaunch("warp" if nw == 1 else "wide",
                                       32 * nw * pairs, -(-N // pairs),
                                       smem, cols, halo, pairs)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def register_reach(pequ32: int, levels: int) -> int:
    """The widest row (a multiple of 32 columns) the register routes
    hold at this Peq size and look-back."""
    lo, hi = 1, 1024            # multiples of 32: 32 .. 32,768
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if register_geometry(1, 32 * mid, pequ32, levels) is None:
            hi = mid - 1
        else:
            lo = mid
    return 32 * lo


def segment_margin(rows: int, levels: int) -> int:
    """Columns before a segment's first owned one that make its window
    exact on every pair: 1 + (rows - 1) 2^levels (the dependency cone of
    the last row, csrc/rescore.cu's header), rounded up to 32."""
    return -(-(1 + (rows - 1) * (1 << levels)) // 32) * 32


def rescore_segments(N: int, rows: int, L1: int, pequ32: int = 0,
                     sms: int = 132, levels: int = 1
                     ) -> RescoreSegments | None:
    """The segment route's windows for N pairs whose rows of L1 columns
    no CTA's registers hold, or None where a window would be mostly
    margin. The margin M is `segment_margin`; a window owns own = Lw - 1
    - M columns, Lw a multiple of 32 of at least 2^levels within
    `register_reach`. Where that reach allows own >= SEG_OWN_SHARE x M,
    Lw is about SEG_WINDOW but not under that share, and smaller where
    the pairs would give under SEG_FILL windows an SM; else the widest
    window, where it still owns a quarter of its columns. So the
    segments leave the shapes whose margin passes three quarters of the
    widest register window, about 13,400 columns at a look-back up to 32
    (rows x 2^levels past about 13,400: e.g. 1,456 rows at a look-back
    of 16 or more, 512 rows at 32), to the cluster and band routes."""
    if levels >= 24:
        return None
    M = segment_margin(rows, levels)
    reach = register_reach(pequ32, levels)
    lo = max(-(-((SEG_OWN_SHARE + 1) * M + 1) // 32) * 32, 1 << levels)
    if lo <= reach:
        fill = -(-(L1 - 1) * N // (SEG_FILL * sms))
        Lw = min(reach, max(lo, min(SEG_WINDOW,
                                    -(-(M + 1 + fill) // 32) * 32)))
    elif 4 * (reach - 1 - M) >= reach and reach >= 1 << levels:
        Lw = reach
    else:
        return None
    own = Lw - 1 - M
    if Lw >= L1 or L1 >= COLUMN_LIMIT:
        return None
    return RescoreSegments(Lw, own, M, -(-(L1 - 1) // own))


def _cluster_limits(kmax) -> tuple[int, ...]:
    """The most CTAs a cluster of each instance (CLUSTER_MAX_THREADS's
    order) from `kmax`: one int for all, or {(cols, kb): CTAs}."""
    if isinstance(kmax, Mapping):
        return tuple(int(kmax.get(inst, 0)) for inst in CLUSTER_MAX_THREADS)
    return (int(kmax),) * len(CLUSTER_MAX_THREADS)


def cluster_geometry(N: int, L1: int, pequ32: int = 0, levels: int = 1,
                     kmax=CLUSTER_MAX, sms: int = 132, rows: int = 0,
                     Lg: int = 0) -> ClusterLaunch | None:
    """The cluster route's launch over N rows of L1 columns, one cluster
    a row, or None where no instance holds it: the key's bits at these
    DP rows (32 where the fields fit 31, else 64; gap_q's field sized by
    `Lg` columns where given, a band's whole row) give the instances;
    each takes halo =
    ceil(w / cols) <= WIDE_MAX_HALO lanes a warp, T warps of 32 - halo
    own lanes cover L1, and K = 2 .. kmax CTAs of nw = ceil(T / K) warps
    (K then ceil(T / nw), so the last CTA holds columns) within its
    thread limit and SMEM_MAX. Of those the least cost of the busiest
    SM: rows x waves x (a row's instruction slots, the larger of one
    warp alone, 2 x cols x ops, and its resident warps' cols x ops over
    four schedulers, plus CLUSTER_BARRIER_CYCLES), ops = 23 + 3 levels a
    column (twice at 64 bits), resident CTAs by the register file of the
    instance's launch bound, the SMs a wave fills those that whole
    clusters fill in a GPC of CLUSTER_GPC_SMS; ties to fewer CTAs.
    `kmax`: the card's largest cluster, one int or {(cols, kb): CTAs}."""
    got = _cluster_best(N, L1, pequ32, levels, kmax, sms, rows, Lg)
    return None if got is None else got[1]


def _cluster_best(N, L1, pequ32, levels, kmax, sms, rows, Lg=0):
    """`cluster_geometry`'s (cost a row, launch), or None."""
    sb, gb, db, w = rescore_key_bits(L1, levels, rows, Lg)
    if sb + gb + db > 63 or N < 1:
        return None
    kb = 32 if sb + gb + db <= 31 else 64
    ops = (23 + 3 * levels) * (2 if kb == 64 else 1)
    best = None
    for (cols, b), lim, kcap in zip(CLUSTER_MAX_THREADS,
                                    CLUSTER_MAX_THREADS.values(),
                                    _cluster_limits(kmax)):
        halo = -(-w // cols)
        if b != kb or halo > WIDE_MAX_HALO:
            continue
        T = -(-L1 // ((32 - halo) * cols))
        for want in range(2, min(kcap, CLUSTER_MAX, T) + 1):
            nw = -(-T // want)
            K = -(-T // nw)
            smem = rescore_wide_smem(nw, halo, cols, pequ32, kb=kb)
            if K < 2 or 32 * nw > lim or smem > SMEM_MAX:
                continue
            per_sm = max(1, lim // (32 * nw))
            slots = CLUSTER_GPC_SMS * per_sm
            ctas = N * K
            waves = -(-ctas // max(1, sms * per_sm * (slots // K * K)
                                   // slots))
            warps = min(per_sm, -(-ctas // sms)) * nw
            cost = waves * (max(2 * cols * ops, warps * cols * ops / 4)
                            + CLUSTER_BARRIER_CYCLES)
            rank = (cost, K * nw * cols, K)
            if best is None or rank < best[0]:
                best = rank, ClusterLaunch(
                    "cluster", 32 * nw, N * K, smem, cols, halo, K, kb,
                    L1, L1 - 1, 0, 1)
    return None if best is None else (best[0][0], best[1])


@functools.lru_cache(maxsize=None)
def _cluster_reach(pequ32: int, levels: int, limits: tuple,
                   rows: int, Lg: int = 0) -> int:
    lo, hi = 0, (1 << 22) // 32 - 1      # multiples of 32 under 2^22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cluster_geometry(1, 32 * mid, pequ32, levels,
                            dict(zip(CLUSTER_MAX_THREADS, limits)),
                            rows=rows, Lg=Lg) is None:
            hi = mid - 1
        else:
            lo = mid
    return 32 * lo


def cluster_reach(pequ32: int, levels: int, kmax=CLUSTER_MAX,
                  rows: int = 0, Lg: int = 0) -> int:
    """The widest row (a multiple of 32 columns, 0 for none) that one
    cluster holds at this Peq size, look-back and DP rows (0: any), its
    gap_q sized by `Lg` columns where given (a band's whole row)."""
    return _cluster_reach(pequ32, levels, _cluster_limits(kmax), rows, Lg)


def rescore_cluster(N: int, rows: int, L1: int, pequ32: int = 0,
                    sms: int = 132, levels: int = 1, kmax=CLUSTER_MAX
                    ) -> ClusterLaunch | None:
    """The cluster route at this shape: one cluster a pair
    (`cluster_geometry`) where one holds the row, else one a window of
    the cluster's reach (`cluster_reach`), each owning Lw - 1 - M columns
    after the margin M of `segment_margin`, while that is at least a
    quarter of the window (the segment route's rule with a cluster's
    reach in place of one CTA's); else None."""
    if levels >= 24 or L1 >= COLUMN_LIMIT:
        return None
    whole = cluster_geometry(N, L1, pequ32, levels, kmax, sms, rows)
    if whole is not None:
        return whole
    Lw = cluster_reach(pequ32, levels, kmax, rows)
    M = segment_margin(rows, levels)
    own = Lw - 1 - M
    if Lw < 1 << levels or 4 * own < Lw or Lw >= L1:
        return None
    segs = -(-(L1 - 1) // own)
    g = cluster_geometry(N * segs, Lw, pequ32, levels, kmax, sms, rows)
    return None if g is None else g._replace(own=own, margin=M, segs=segs)


def rescore_bands(N: int, rows: int, L1: int, pequ32: int = 0,
                  sms: int = 132, levels: int = 1, kmax=CLUSTER_MAX,
                  wmax: int = 0) -> ClusterLaunch | None:
    """The band route at this shape, or None where no cluster holds a
    window (a look-back past 512, or L1 of COLUMN_LIMIT or more): a
    pair's rows in bands of R (band 0 rows 1 .. R, band b rows b R + 1
    .. (b + 1) R), each band one cluster-route launch over windows of Lw
    columns owning Lw - 1 - M after the band's cone M =
    `segment_margin`(R + 1) (a band past the first starts from the
    stored row before it: csrc/rescore.cu's header), the key's gap_q
    field sized by the whole row (`Lg` = L1). The pairs go in chunks
    whose two stored rows (8 bytes a column a pair) stay within
    BAND_ROW_BYTES. R (1, 2, 4, .. up to the rows) and Lw (the cluster's
    reach at that key, capped at `wmax` where given, or a few multiples
    of the margin under it) from the least cost of the busiest SM: the
    chunks' rows x `cluster_geometry`'s cost a row over the windows,
    plus each band launch's BAND_LAUNCH_CYCLES and its stored rows' and
    Peq tables' bytes at BAND_BYTES_CYCLE; ties to fewer bands."""
    if levels >= 24 or L1 >= COLUMN_LIMIT or rows >= 1 << 16 or N < 1:
        return None
    return _bands(N, rows, L1, pequ32, sms, levels, _cluster_limits(kmax),
                  wmax)


@functools.lru_cache(maxsize=4096)
def _bands(N, rows, L1, pequ32, sms, levels, limits, wmax):
    kmax = dict(zip(CLUSTER_MAX_THREADS, limits))
    chunk = max(1, min(N, BAND_ROW_BYTES // (16 * L1)))
    calls = -(-N // chunk)
    reach = cluster_reach(pequ32, levels, kmax, rows, L1)
    if wmax:
        reach = min(reach, wmax // 32 * 32)
    best, R = None, 1
    while True:
        Rb = min(R, rows)
        M = segment_margin(Rb + 1, levels)
        for Lw in sorted({reach} | {-(-m * (M + 1) // 32) * 32
                                    for m in (2, 3, 4, 6, 8, 16, 32)}):
            own = Lw - 1 - M
            if Lw > reach or own < 32 or Lw < 1 << levels or Lw >= L1:
                continue
            segs = -(-(L1 - 1) // own)
            got = _cluster_best(chunk * segs, Lw, pequ32, levels, kmax, sms,
                                rows, L1)
            if got is None:
                continue
            per_row, g = got
            nb = -(-rows // Rb)
            over = BAND_LAUNCH_CYCLES + (16 * L1 * chunk + 4 * pequ32
                                         * g.grid) / BAND_BYTES_CYCLE
            rank = (calls * (rows * per_row + nb * over), nb, Lw)
            if best is None or rank < best[0]:
                best = rank, g._replace(route="bands", own=own, margin=M,
                                        segs=segs, band=Rb, chunk=chunk)
        if R >= rows:
            return None if best is None else best[1]
        R *= 2


def rescore_geometry(N: int, rows: int, L1: int, pequ32: int = 0,
                     sms: int = 132, levels: int = 1, kmax=CLUSTER_MAX
                     ) -> RescoreLaunch | ClusterLaunch:
    """The K3 launch over N pairs of `pequ32` (C x W) Peq words with a
    2^levels look-back, the row in registers wherever one CTA's hold it:
    C columns a thread (a multiple of 4 up to 32; a power of two unless
    one warp holds the row and the window fits a lane's run), one warp a
    pair where 32 C columns hold the row ("warp": WARP_PAIRS pairs a CTA,
    fewer where their tables pass WARP_SMEM), else warps of 32 - H own
    lanes after H halo lanes (H C >= the window), as few warps as cover
    L1 ("wide", one CTA a pair), within the instance's thread limit and
    the shared memory a CTA may opt into; of those one warp a pair where
    it can, then the fewest column slots, then the fewest columns a
    thread. The key is 32 bits where the shape's fields fit 31, else 64
    (one warp of 32 columns a thread: L1 = 1,024 at levels 10); a pair
    across warps takes 8, 16 or 32 columns a thread and a 32-bit key,
    as before the warp route. Past them the segment route
    (`rescore_segments`: overlapping windows on those routes, N x segs
    items, then the merge); where a window would be mostly margin the
    cluster route (`rescore_cluster`: a ClusterLaunch, one cluster of up
    to `kmax` CTAs a pair, or a window of its reach, then the merge);
    where even those windows would be mostly margin (1 + (rows - 1)
    2^levels past three quarters of a cluster's reach: 4,480 rows at a
    look-back of 32 or 64, 3,104 at 64 past about 184 kbp, 1,456 at 128
    or 256 past about 172 kbp) the band route (`rescore_bands`: the rows
    in bands, each band's windows on the cluster route with the band's
    margin). Only where no cluster holds a window the global route at
    any L1 (no shared memory but the reduction's: the row state in a
    scratch of 32 bytes a column a CTA, the codes read from the tiles;
    one CTA per SM, fewer where the scratch would pass GLOBAL_SCRATCH
    bytes, walking over the pairs): a look-back of 1,024 or more past
    one warp's 1,024 columns (no instance's halo holds it; an ED budget
    of at most 254, as every path caps it, gives 256 at most), or L1 of
    COLUMN_LIMIT (2^27) or more."""
    reg = register_geometry(N, L1, pequ32, levels)
    if reg is not None:
        return reg
    sg = rescore_segments(N, rows, L1, pequ32, sms, levels)
    if sg is not None:
        return register_geometry(N * sg.segs, sg.window, pequ32,
                                 levels)._replace(route="segments")
    cl = rescore_cluster(N, rows, L1, pequ32, sms, levels, kmax)
    if cl is not None:
        return cl
    bd = rescore_bands(N, rows, L1, pequ32, sms, levels, kmax)
    if bd is not None:
        return bd
    cap = GLOBAL_SCRATCH // (4 * 8 * L1)
    return RescoreLaunch("global", GLOBAL_THREADS,
                         max(1, min(N, sms, cap)), 0)


def rescore(peq_flat: torch.Tensor, tiles: torch.Tensor,
            qmeta: torch.Tensor, W: int, levels: int, rows: int,
            L1: int, tidx: torch.Tensor | None = None) -> torch.Tensor:
    """K3: [4, N] int32 (ed, gap_q, gap_r, final_pos). peq_flat
    [N, C*W] int32 bits (C = 16 codes, or 256 for raw-byte queries),
    tiles [N, L1-1] uint8, qmeta [N, 2] int32 (qlen, max_ed). With
    `tidx` ([N] int64, each under NT) tiles are bucket rows [NT, Lt]
    (Lt <= L1 - 1, unit column stride) and pair n's tile is row tidx[n]
    padded with code 0: the segment and cluster routes read them in
    place, the others from a gathered copy."""
    N = peq_flat.shape[0]
    dev = peq_flat.device
    C = peq_flat.shape[1] // W if peq_flat.dim() == 2 else 0
    if C not in RESCORE_CODES:
        raise ValueError(f"peq_flat: expected [N, C*{W}] with C in "
                         f"{RESCORE_CODES}, got {tuple(peq_flat.shape)}")
    tshape = (N, L1 - 1)
    if tidx is not None:
        tshape = (tiles.shape[0], min(tiles.shape[1], L1 - 1)) \
            if tiles.dim() == 2 else ()
        if tidx.device != dev or tidx.dtype != torch.int64 or \
                tuple(tidx.shape) != (N,):
            raise ValueError(f"tidx: expected int64 ({N},) on {dev}, got "
                             f"{tidx.dtype} {tuple(tidx.shape)} on "
                             f"{tidx.device}")
    for name, t, dt, shape in (
            ("peq_flat", peq_flat, torch.int32, (N, C * W)),
            ("tiles", tiles, torch.uint8, tshape),
            ("qmeta", qmeta, torch.int32, (N, 2))):
        dense = t.is_contiguous() or (t is tiles and tidx is not None
                                      and t.stride(-1) == 1)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not dense:
            raise ValueError(
                f"{name}: expected contiguous {dt} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= rows <= 32 * W:
        raise ValueError(f"rows={rows} outside 1..32W = {32 * W}")
    if L1 % 32 or L1 < 32:
        raise ValueError(f"L1={L1}: the rescore takes a multiple of 32 "
                         "columns")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    gathered = lambda: torch.nn.functional.pad(
        tiles[tidx], (0, L1 - 1 - tiles.shape[1])).contiguous()
    if not peq_flat.is_cuda:
        return rescore_plain(peq_flat, tiles if tidx is None else
                             gathered(), qmeta, W, levels, rows, L1)
    out = torch.empty((4, N), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    sms = sm_count(dev)
    g = rescore_geometry(N, rows, L1, C * W, sms, levels,
                         cluster_limits(dev, C * W, levels))
    if tidx is not None and g.route not in ("segments", "cluster", "bands"):
        tiles, tidx = gathered(), None
    if g.route == "segments":
        return rescore_merge(_segment_parts(peq_flat, tiles, qmeta, W,
                                            levels, rows, L1, tidx, g),
                             qmeta, rows)
    if g.route == "cluster":
        out = _cluster_run(peq_flat, tiles, qmeta, W, levels, rows, L1,
                           tidx, g)
        return out if g.segs == 1 else rescore_merge(out, qmeta, rows)
    if g.route == "bands":
        return _band_run(peq_flat, tiles, qmeta, W, levels, rows, L1, tidx,
                         g)
    scratch = torch.empty(4 * g.grid * L1 if g.route == "global" else 0,
                          dtype=torch.int64, device=dev)
    _build.launch(
        dev, _build.load("rescore", _SIG).rescore_wide_launch,
        peq_flat.data_ptr(), tiles.data_ptr(), qmeta.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch.numel() else None, N,
        W, C, levels, rows, L1, g.cols, g.halo, g.pairs, g.threads, g.grid,
        g.smem, torch.cuda.current_stream(dev).cuda_stream,
        what=f"rescore_wide_launch ({g.route})")
    rescore.launches += 1
    rescore.routes[g.route] += 1
    return out


rescore.launches = 0
rescore.routes = {"warp": 0, "wide": 0, "segments": 0, "cluster": 0,
                  "bands": 0, "global": 0}


@functools.lru_cache(maxsize=None)
def _cluster_limits_on(index: int, pequ32: int, levels: int
                       ) -> tuple[tuple[tuple[int, int], int], ...]:
    lib = _build.load("rescore", _SIG)
    w = 1 << levels
    got = []
    for (cols, kb), lim in CLUSTER_MAX_THREADS.items():
        halo = -(-w // cols)
        smem = rescore_wide_smem(lim // 32, halo, cols, pequ32, kb=kb)
        n = ctypes.c_int(0)
        if halo <= WIDE_MAX_HALO and smem <= SMEM_MAX:
            with torch.cuda.device(index):
                _build.check(lib.rescore_cluster_max(
                    cols, kb, lim, smem, ctypes.byref(n)),
                    "rescore_cluster_max")
        got.append(((cols, kb), min(n.value, CLUSTER_MAX)))
    return tuple(got)


def cluster_limits(device, pequ32: int, levels: int) -> dict:
    """{(cols, kb): the largest cluster the card co-schedules} for the
    cluster route's instances at their launch bound and the most shared
    memory they plan at this Peq size and look-back (the card's
    `cudaOccupancyMaxPotentialClusterSize`, cached a device): a launch
    of fewer threads and bytes is granted at least as many CTAs."""
    dev = torch.device(device)
    return dict(_cluster_limits_on(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        pequ32, levels))


def _cluster_run(peq_flat, tiles, qmeta, W, levels, rows, L1, tidx, g):
    """The cluster kernel's launch `g` (`rescore`'s checked CUDA
    arguments): [4, N] for whole rows, else the windows' [5, N*S]."""
    N, dev = peq_flat.shape[0], peq_flat.device
    C = peq_flat.shape[1] // W
    out = torch.empty((4, N) if g.segs == 1 else (5, N * g.segs),
                      dtype=torch.int32, device=dev)
    _build.launch(
        dev, _build.load("rescore", _SIG).rescore_cluster_launch,
        peq_flat.data_ptr(), tiles.data_ptr(),
        None if tidx is None else tidx.data_ptr(), qmeta.data_ptr(),
        out.data_ptr(), N, W, C, levels, rows, L1, tiles.shape[1],
        tiles.stride(0), g.window, g.own, g.margin, g.segs, g.cols,
        g.halo, g.threads // 32, g.cluster, g.smem,
        torch.cuda.current_stream(dev).cuda_stream,
        what=f"rescore_cluster_launch ({g.cluster} CTAs a cluster)")
    rescore.launches += 1
    rescore.routes["cluster"] += 1
    return out


def _band_run(peq_flat, tiles, qmeta, W, levels, rows, L1, tidx, g):
    """The band route's launches `g` (`rescore`'s checked CUDA
    arguments): for each chunk of `g.chunk` pairs one launch a band over
    its windows, the stored rows in two [n, L1] buffers of 8-byte states
    (a band reads the one the band before wrote), then the merge of the
    last band's [5, n*S] partial results. Returns [4, N]."""
    N, dev = peq_flat.shape[0], peq_flat.device
    C = peq_flat.shape[1] // W
    entry = _build.load("rescore", _SIG).rescore_band_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for c0 in range(0, N, g.chunk):
        n = min(g.chunk, N - c0)
        pc, qm = peq_flat[c0:c0 + n], qmeta[c0:c0 + n]
        tl, ti = (tiles[c0:c0 + n], None) if tidx is None else \
            (tiles, tidx[c0:c0 + n])
        buf = torch.empty((2, n, L1), dtype=torch.int64, device=dev)
        part = torch.empty((5, n * g.segs), dtype=torch.int32, device=dev)
        y0, b = 0, 0
        while True:
            y1 = min(rows, y0 + g.band)
            last = y1 == rows
            _build.launch(
                dev, entry, pc.data_ptr(), tl.data_ptr(),
                None if ti is None else ti.data_ptr(), qm.data_ptr(),
                buf[b % 2].data_ptr() if y0 else None,
                None if last else buf[(b + 1) % 2].data_ptr(),
                part.data_ptr() if last else None, n, W, C, levels, rows,
                L1, tl.shape[1], tl.stride(0), g.window, g.own, g.margin,
                g.segs, y0, y1, g.cols, g.halo, g.threads // 32, g.cluster,
                g.smem, stream,
                what=f"rescore_band_launch (rows {y0 + 1}-{y1})")
            rescore.launches += 1
            rescore.routes["bands"] += 1
            if last:
                break
            y0, b = y1, b + 1
        outs.append(rescore_merge(part, qm, rows))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _segment_parts(peq_flat, tiles, qmeta, W, levels, rows, L1, tidx, g):
    """The segment kernel's launch `g` (`rescore`'s checked CUDA
    arguments): the [5, N*S] partial results, one column a (pair,
    segment) item."""
    N, dev = peq_flat.shape[0], peq_flat.device
    C = peq_flat.shape[1] // W
    sg = rescore_segments(N, rows, L1, C * W, sm_count(dev), levels)
    part = torch.empty((5, N * sg.segs), dtype=torch.int32, device=dev)
    _build.launch(
        dev, _build.load("rescore", _SIG).rescore_seg_launch,
        peq_flat.data_ptr(), tiles.data_ptr(),
        None if tidx is None else tidx.data_ptr(), qmeta.data_ptr(),
        part.data_ptr(), N, W, C, levels, rows, L1, tiles.shape[1],
        tiles.stride(0), sg.window, sg.own, sg.margin, sg.segs, g.cols,
        g.halo, g.pairs, g.threads, g.grid, g.smem,
        torch.cuda.current_stream(dev).cuda_stream,
        what="rescore_seg_launch")
    rescore.launches += 1
    rescore.routes["segments"] += 1
    return part


def rescore_segment_parts(peq_flat: torch.Tensor, tiles: torch.Tensor,
                          qmeta: torch.Tensor, W: int, levels: int,
                          rows: int, L1: int) -> torch.Tensor:
    """The segment route's first launch alone, on CUDA tensors of a
    shape `rescore_geometry` sends there (`rescore`'s arguments without
    tile indices): the [5, N*S] partial results that `rescore_merge`
    joins (counted as `rescore`'s launch)."""
    N, C = peq_flat.shape[0], peq_flat.shape[1] // W
    g = rescore_geometry(N, rows, L1, C * W, sm_count(peq_flat.device),
                         levels)
    if not peq_flat.is_cuda or g.route != "segments":
        raise ValueError(f"not a segment-route launch on a card: {g}")
    return _segment_parts(peq_flat, tiles, qmeta, W, levels, rows, L1,
                          None, g)


def rescore_merge_plain(part: torch.Tensor, qmeta: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """The segments' merge in PyTorch: part [5, N*S] int32 (per segment
    its least score, greatest gap_q at it, first column, that column's
    shiftR, last column) -> [4, N] as rescore_plain's final reduction."""
    N = qmeta.shape[0]
    s, g, first, r, last = part.long().reshape(5, N, -1)
    best_s = s.min(dim=1).values
    is_min = s == best_s[:, None]
    best_g = torch.where(is_min, g, -1).max(dim=1).values
    is_best = is_min & (g == best_g[:, None])
    first_col = torch.where(is_best, first, 1 << 30).min(dim=1).values
    last_col = torch.where(is_best, last, -1).max(dim=1).values
    best_r = torch.where(is_best & (first == first_col[:, None]), r,
                         -(1 << 30)).max(dim=1).values
    return torch.stack([best_s.clamp(max=255), best_g, best_r,
                        last_col - (rows - qmeta[:, 0].long())]
                       ).to(torch.int32)


def rescore_merge(part: torch.Tensor, qmeta: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """K3's segment merge (`rescore_merge_kernel`, one warp a pair):
    [4, N] from the segment kernel's part [5, N*S]; launches it for CUDA
    tensors (counted in `launches`), `rescore_merge_plain` for CPU
    ones."""
    N = qmeta.shape[0]
    if part.dim() != 2 or part.shape[0] != 5 or N == 0 or \
            part.shape[1] % N or part.dtype != torch.int32 or \
            not part.is_contiguous() or part.device != qmeta.device:
        raise ValueError(f"part: expected contiguous int32 [5, N*S] with "
                         f"N = {N} on {qmeta.device}, got {part.dtype} "
                         f"{tuple(part.shape)} on {part.device}")
    if not part.is_cuda:
        return rescore_merge_plain(part, qmeta, rows)
    out = torch.empty((4, N), dtype=torch.int32, device=part.device)
    _build.launch(
        part.device, _build.load("rescore", _SIG).rescore_merge_launch,
        part.data_ptr(), qmeta.data_ptr(), out.data_ptr(), N,
        part.shape[1] // N, rows,
        torch.cuda.current_stream(part.device).cuda_stream,
        what="rescore_merge_launch")
    rescore_merge.launches += 1
    return out


rescore_merge.launches = 0


def rescore_pairs_gather(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                         pidx: np.ndarray, tidx: np.ndarray,
                         qlens: np.ndarray, max_ed: np.ndarray, W: int,
                         x0: np.ndarray | None = None,
                         Lw: int | None = None) -> torch.Tensor:
    """Rescore one chunk of pairs against device-resident Peq planes
    [NQ, C, W] and tiles [NT, Lt]; returns the [4, N] device result.

    With x0/Lw the DP runs on per-pair [Lw-1]-column windows starting
    at column x0 (final_pos is window-local: the caller adds x0 back);
    otherwise on the whole tile, padded to the kernel's L1-1 columns
    (`rescore` with the tile indices: no full-width copy on the segment
    route)."""
    dev = peq_all.device
    rows = rows_for(qlens, W)
    L1 = l1_for(tiles_all.shape[1] if Lw is None else Lw - 1)
    tidx = np.asarray(tidx, dtype=np.int64)
    if len(tidx) and not 0 <= tidx.min() <= tidx.max() < len(tiles_all):
        raise ValueError(f"tidx: rows outside 0 .. {len(tiles_all) - 1}")
    pi = torch.from_numpy(np.asarray(pidx, dtype=np.int64)).to(dev)
    ti = torch.from_numpy(tidx).to(dev)
    peq = peq_all[pi].reshape(len(pidx), peq_all.shape[1] * W)
    qmeta = torch.from_numpy(np.stack(
        [qlens.astype(np.int32), max_ed.astype(np.int32)], axis=1)
    ).to(dev)
    if x0 is None:      # the bucket rows by tile index
        return rescore(peq.contiguous(), tiles_all, qmeta, W,
                       levels_for(max_ed), rows, L1, tidx=ti)
    x0_d = torch.from_numpy(np.asarray(x0, dtype=np.int64)).to(dev)
    return rescore(peq.contiguous(),
                   window_tiles(tiles_all[ti], x0_d, L1).contiguous(),
                   qmeta, W, levels_for(max_ed), rows, L1)
