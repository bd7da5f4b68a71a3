"""Wrappers of the Myers kernels: the pair kernel
(`csrc/myers_pairs.cu`; K1 over the nibble-packed tile store, K2 over
tiles of one code per byte, one kernel family reading the rows in place)
and the dense cross kernel (`csrc/myers_cross.cu`; K4, int32 or uint8
clipped at 255, over Peq tables of 16 codes or, for raw-byte queries,
256). The launch geometry of each is pure Python
(`pair_geometry`, `cross_geometry`), so the CPU tests reach it.

Each kernel has a second, wide route for W > 16 (queries over 512
residues; for the pair kernel also where a score could pass its packed
position keys' 15 bits), W at run time: the pair kernel's a group of
8-32 lanes a pair, the words in registers, the carry across lanes by
ballots (`pair_wide_geometry`); the cross kernel's the same lane groups
with each pair's columns split into overlapping segments where the
launch leaves the card idle (`cross_group_geometry`), else one thread a
pair with the words in shared memory (`cross_wide_geometry`); each past
what that holds with the words in a global scratch allocated here. The
cross kernel's narrow launches (W <= 16) that leave the card idle take
its thin route (`cross_thin_geometry`): lanes across queries, each
tile's columns in the same overlapping segments.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version from `kernels.myers`. Each wrapper
counts its own launches in its `launches` attribute, the wide routes'
among them in `wide`, the cross kernel's lane-group launches among
those in `group` and its thin launches in `thin`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .myers import (myers_cross_plain, myers_pairs_packed_plain,
                    myers_pairs_plain)

NARROW_W = 16       # Myers words of the register-resident instances
KEY_LIMIT = 32768   # the narrow pair kernel's packed keys: scores under it
CROSS_CODES = (16, 256)       # K4: Peq codes, nucleotide or raw byte
CROSS_TILES_PER_CTA = 128     # K4: tiles per CTA at most, one per thread
CROSS_MAX_QGROUPS = 65535     # K4: query groups ride on grid.y
PAIR_SMEM_LIMIT = 48 * 1024   # static limit: no opt-in needed below it
SMEM_OPT_IN = 232448          # dynamic shared memory a CTA may opt into
CROSS_RING_BYTES = 2 * 8 * CROSS_TILES_PER_CTA * 4   # K4's tile ring
GLOBAL_SCRATCH = 256 << 20    # a global route's scratch per launch, at most
PAIR_GROUPS = (8, 16, 32)     # K1/K2 wide: lanes a pair
PAIR_WORDS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 28)  # words a lane
PAIR_THREADS = 128            # K1/K2 wide: threads a CTA (32 small launches)
# K4 wide: the one-thread-a-pair route where a launch's pairs give every
# warp scheduler this many warps, else lane groups (and column segments
# up to that many lanes in flight)
CROSS_FILL_WARPS = 3
CROSS_GROUP_THREADS = 128     # K4 lane groups: threads a CTA, at most
# K4 thin: segments (warps) a CTA, at most: small CTAs, so that a launch
# of a few hundred of them spreads evenly over the SMs
CROSS_THIN_WARPS = 4
# K4 thin: warps a scheduler that keep the scan's int32 pipe busy (on an
# H100 two such warps ran at 0.82-0.93 of the SM's int32 rate; PERF.md)
CROSS_THIN_ISSUE_WARPS = 2
# K4 thin: the route takes a launch only where its estimate is under the
# narrow kernel's over this (at 42 rows against 397 tiles of 416 columns
# an estimate of 0.69 of it ran 0.87x in turns on an H100; PERF.md)
CROSS_THIN_GAIN = 2
FMT_PACKED, FMT_BYTES = 0, 1
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"myers_pairs_launch": [_P] * 5 + [_I] * 10 + [_P],
        "myers_pairs_wide_launch": [_P] * 6 + [_I] * 11 + [_P]}
_SIG_CROSS = {"myers_cross_launch": [_P, _P, _P] + [_I] * 10 + [_P],
              "myers_cross_wide_launch": [_P] * 4 + [_I] * 10 + [_P],
              "myers_cross_group_launch": [_P] * 3 + [_I] * 15 + [_P],
              "myers_cross_thin_launch": [_P] * 4 + [_I] * 14 + [_P]}
_CROSS_DTYPES = {torch.int32: 0, torch.uint8: 1}


def pair_geometry(B: int, W: int, sms: int = 132) -> tuple[int, int, int]:
    """(blocks, threads per CTA, dynamic shared-memory bytes) of a pair
    kernel launch over B pairs of W-word queries. One thread owns one
    pair and stages its Peq table (64 W bytes) in shared memory. Small
    launches take one warp per CTA so that the pairs spread over every
    SM; from four CTAs per SM on, CTAs of 64 then 128 threads, as far as
    their tables stay within the 48 KB of shared memory a kernel may use
    without opting in."""
    threads = 32
    for cand in (128, 64):
        if cand * 64 * W <= PAIR_SMEM_LIMIT and -(-B // cand) >= 4 * sms:
            threads = cand
            break
    return -(-B // threads), threads, threads * 64 * W


def cross_geometry(Q: int, T: int, W: int
                   ) -> tuple[int, int, tuple[int, int]]:
    """(NQ, threads per CTA, grid (x, y)) of a K4 launch over Q queries
    of W words and T tiles: NQ queries a thread, so that a thread always
    runs at least two independent carry chains (4 at W <= 4, 2 above:
    VP/VN of NQ x W words in registers); one tile a thread, 128 tiles a
    CTA (fewer, in whole warps, when T is smaller); tile groups on grid.x
    and query groups on grid.y. Past W = 16 the one-thread-a-pair wide
    route's (`cross_wide_geometry`: one query a CTA), the tile groups
    by which `engine.cross_blocks` sizes launches whichever wide route
    then runs them."""
    if W > NARROW_W:
        threads, grid, _, _ = cross_wide_geometry(Q, T, W)
        return 1, threads, grid
    nq = 4 if W <= 4 else 2
    threads = min(CROSS_TILES_PER_CTA, max(32, -(-T // 32) * 32))
    return nq, threads, (-(-T // threads), -(-Q // nq))


def pair_wide(W: int, ncols: int) -> bool:
    """Whether a pair launch takes the wide route: past the narrow
    instances' W, or where a score (at most 32W + columns) could pass
    their packed keys."""
    return W > NARROW_W or 32 * W + ncols >= KEY_LIMIT


class PairWideLaunch(NamedTuple):
    """A wide pair launch: lanes a pair (1: one thread a pair, its words
    in a global scratch), Myers words a lane, CTAs, threads a CTA,
    dynamic shared-memory bytes and global scratch words."""
    group: int
    words: int
    blocks: int
    threads: int
    smem: int
    scratch: int


def pair_group(W: int) -> tuple[int, int] | None:
    """(lanes a pair G, words a lane K) for W Myers words: K the fewest
    instantiated words that hold W / G; of the G whose idle word slots
    (G K - W) are at most a quarter, the fewest lanes, else the fewest
    idle slots' share; None past 28 words a lane at 32 lanes."""
    best = None
    for G in PAIR_GROUPS:
        K = next((k for k in PAIR_WORDS if G * k >= W), None)
        if K is None:
            continue
        idle = (G * K - W) / (G * K)
        rank = (idle > 0.25, idle if idle > 0.25 else 0, G)
        if best is None or rank < best[0]:
            best = (rank, G, K)
    return None if best is None else best[1:]


def pair_wide_geometry(B: int, W: int, sms: int = 132) -> PairWideLaunch:
    """The wide pair launch over B pairs: a group of G lanes a pair, K
    words a lane in registers (`pair_group`), the group's Peq table in
    shared memory (64 K G bytes); CTAs of 128 threads, 32 while that
    leaves under eight warps an SM. Past 28 x 32 words one thread a
    pair, 32 threads a CTA, its words in a global scratch of at most
    GLOBAL_SCRATCH bytes, the CTAs walking over the pairs (shared memory
    0)."""
    gk = pair_group(W)
    if gk is None:
        blocks = max(1, min(-(-B // 32), GLOBAL_SCRATCH // (32 * 8 * W)))
        return PairWideLaunch(1, 0, blocks, 32, 0, blocks * 32 * 2 * W)
    G, K = gk
    threads = 32 if B * G < 32 * 8 * sms else PAIR_THREADS
    return PairWideLaunch(G, K, -(-B * G // threads), threads,
                          threads * 64 * K, 0)


def cross_wide_geometry(Q: int, T: int, W: int
                        ) -> tuple[int, tuple[int, int], int, int]:
    """(threads per CTA, grid (x, y), dynamic shared-memory bytes, global
    scratch words) of a wide K4 launch (W > 16) over Q queries and T
    tiles: one query a CTA (grid.y), one tile a thread, 128 tiles a CTA
    (fewer, in whole warps, when T is smaller), 8W bytes of Myers words
    a thread in shared memory beside the 8 KB tile ring; where even 32
    threads' words pass what a CTA may opt into, they go to a global
    scratch of 2W words a thread (shared memory 0), and the caller
    launches the queries in groups that keep it under GLOBAL_SCRATCH."""
    threads = min(CROSS_TILES_PER_CTA, max(32, -(-T // 32) * 32))
    while threads > 32 and threads * 8 * W + CROSS_RING_BYTES > SMEM_OPT_IN:
        threads -= 32
    grid = (-(-T // threads), Q)
    if threads * 8 * W + CROSS_RING_BYTES <= SMEM_OPT_IN:
        return threads, grid, threads * 8 * W, 0
    return threads, grid, 0, grid[0] * Q * threads * 2 * W


class CrossGroupLaunch(NamedTuple):
    """A K4 launch on the lane-group route: lanes a pair G, Myers words
    a lane K, column segments a pair S, the columns a segment owns, the
    columns it scans before its first, tiles a CTA P, threads a CTA,
    grid (x, y) and dynamic shared-memory bytes."""
    group: int
    words: int
    segments: int
    seg: int
    over: int
    pairs: int
    threads: int
    grid: tuple[int, int]
    smem: int


def cross_overlap(W: int, u8: bool) -> int:
    """Columns a K4 segment scans before its first, as few as keep the
    segments' least minimum exact (csrc/myers_cross.cu): an alignment of
    the 32W query rows with e edits spans at most 32W + e columns, and
    the minimum is at most 32W (int32) or matters only below 255
    (uint8); rounded up to whole 32-column chunks."""
    return -(-(32 * W + min(32 * W, 255 if u8 else 32 * W)) // 32) * 32


def cross_group_geometry(Q: int, T: int, W: int, Lp: int, C: int = 16,
                         u8: bool = True, sms: int = 132,
                         force: bool = False, group: int | None = None,
                         segments: int | None = None
                         ) -> CrossGroupLaunch | None:
    """The lane-group launch of a wide K4 call (W > 16) over Q queries
    and T tiles of Lp columns, or None where the one-thread-a-pair route
    (`cross_wide_geometry`) runs it: where the pairs alone give each of
    the card's warp schedulers CROSS_FILL_WARPS warps (unless `force`),
    past 28 x 32 words, or where the query's Eq table would not fit a
    CTA's shared memory. A group of G lanes a pair, K words a lane
    (`pair_group`: the fewest lanes); each pair's columns in S segments
    while the lanes in flight stay under that fill, a segment no shorter
    than a quarter of its overlap (`cross_overlap`) and a pair's
    segments within one CTA of at most CROSS_GROUP_THREADS threads; P
    tiles a CTA of about that many threads, in whole warps; one query a
    CTA (grid.y), its Eq table in shared memory beside the two-stage
    tile ring and the segment minima. `force` takes this route whatever the
    fill; `group` and `segments` set G and S (the segments then as near
    S as whole 32-column chunks allow) in place of the planned ones."""
    gk = pair_group(W)
    fill = CROSS_FILL_WARPS * sms * 4 * 32
    if gk is None or (not force and group is None and segments is None
                      and Q * T >= fill):
        return None
    G, K = gk
    if group is not None:
        G, K = group, next(k for k in PAIR_WORDS if group * k >= W)
    over = cross_overlap(W, u8)
    S = segments or max(1, min(fill // (Q * T * G),
                               CROSS_GROUP_THREADS // G,
                               4 * (Lp - over) // over))
    seg = -(-(-(-Lp // S)) // 32) * 32
    S = max(1, -(-Lp // seg)) if seg else 1
    P = max(1, min(T, CROSS_GROUP_THREADS // (S * G)))
    groups = -(-P * S * G // 32) * 32 // G
    smem = 4 * C * K * G + 68 * groups
    if smem > SMEM_OPT_IN:
        return None
    return CrossGroupLaunch(G, K, S, seg, over, P, groups * G,
                            (-(-T // P), Q), smem)


class CrossThinLaunch(NamedTuple):
    """A K4 launch on the thin route: queries a lane NQ, column segments
    a tile S, the columns a segment owns, the columns it scans before
    its first, segments (warps) a CTA, CTAs a tile (the partial minima
    merged by a second kernel where more than one), grid (x, y) and
    dynamic shared-memory bytes."""
    nq: int
    segments: int
    seg: int
    over: int
    warps: int
    parts: int
    grid: tuple[int, int]
    smem: int


def _busiest(ctas: int, warps: int, sms: int) -> float:
    """Warps a scheduler of the busiest SM holds: a launch's CTAs of
    `warps` warps spread over `sms` SMs of four schedulers."""
    return -(-ctas // sms) * warps / 4


def _thin_plan(Lp: int, S: int, warps: int) -> tuple[int, int, int, int]:
    """(segments, columns a segment owns, CTAs a tile, segments a CTA)
    for about S segments of whole 32-column chunks, at most `warps` a
    CTA, a tile's segments over its CTAs as even as that allows."""
    seg = -(-(-(-Lp // S)) // 32) * 32
    S = max(1, -(-Lp // seg)) if seg else 1
    parts = -(-S // warps)
    return S, seg, parts, -(-S // parts)


@functools.lru_cache(maxsize=4096)
def cross_thin_geometry(Q: int, T: int, W: int, Lp: int, C: int = 16,
                        u8: bool = True, sms: int = 132,
                        force: bool = False, segments: int | None = None,
                        warps: int | None = None
                        ) -> CrossThinLaunch | None:
    """The thin launch of a narrow K4 call (W <= 16) over Q queries and
    T tiles of Lp columns, or None where `cross_geometry`'s (one tile a
    thread) runs it: where the pairs, NQ a thread, give each of the
    card's warp schedulers CROSS_FILL_WARPS warps, where it would plan
    one segment a tile (nothing to split: the narrow kernel keeps the
    launch), or where it would not take under 1 / CROSS_THIN_GAIN of
    that one's time (`force` takes it whatever the shape). Lanes across queries, 32 NQ
    a CTA (query blocks on grid.y); each tile's columns in S segments,
    at most CROSS_THIN_WARPS a CTA (`warps` in its place, up to 8), a
    tile's segments over `parts` CTAs as even as that allows; the Eq
    tables (C = 16) in shared memory beside the warps' minima. S is the
    count that
    takes least time by the columns a warp scans (seg + over) times the
    warps a scheduler of the busiest SM holds, counted as no fewer than
    CROSS_THIN_ISSUE_WARPS (below that the pipe idles as long); S runs
    up to twice the CROSS_FILL_WARPS fill and keeps a segment no shorter
    than a quarter of its overlap (`cross_overlap`). `segments` sets S
    (then as near as whole 32-column chunks allow). The narrow launch is
    timed by the same measure: Lp columns a warp."""
    if W > NARROW_W:
        return None
    nq = 4 if W <= 4 else 2
    fill = CROSS_FILL_WARPS * sms * 4          # warps
    if not force and segments is None and -(-Q // nq) * T >= fill * 32:
        return None
    qblocks = -(-Q // (32 * nq))
    over = cross_overlap(W, u8)
    cap = warps or CROSS_THIN_WARPS

    def cost(plan):
        S, seg, parts, w = plan
        cols = seg + over if S > 1 else Lp
        return cols * max(CROSS_THIN_ISSUE_WARPS,
                          _busiest(qblocks * T * parts, w, sms))
    if segments:
        plan = _thin_plan(Lp, segments, cap)
    else:
        top = max(1, min(4 * (Lp - over) // over,
                         2 * fill // (qblocks * T)))
        plan = min((_thin_plan(Lp, S, cap) for S in range(1, top + 1)),
                   key=cost)
    if not force and segments is None:
        _, threads, (gx, gy) = cross_geometry(Q, T, W)
        narrow = Lp * max(CROSS_THIN_ISSUE_WARPS,
                          _busiest(gx * gy, threads // 32, sms))
        if plan[0] == 1 or CROSS_THIN_GAIN * cost(plan) >= narrow:
            return None
    S, seg, parts, w = plan
    smem = 4 * 32 * nq * ((16 * W if C == 16 else 0) + w)
    return CrossThinLaunch(nq, S, seg, over, w, parts, (T * parts, qblocks),
                           smem)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def _check_inputs(peq_all, tiles, pidx, tidx, W: int):
    dev = peq_all.device
    for name, t in (("peq_all", peq_all), ("tiles", tiles),
                    ("pidx", pidx), ("tidx", tidx)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if W < 1:
        raise ValueError(f"W={W}: a query has at least one Myers word")
    if peq_all.dtype != torch.int32 or peq_all.dim() != 3 or \
            tuple(peq_all.shape[1:]) != (16, W):
        raise ValueError(f"peq_all must be int32 [NQ, 16, {W}], got "
                         f"{peq_all.dtype} {tuple(peq_all.shape)}")
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError("tiles must be a 2-D uint8 tensor")
    if pidx.dtype != torch.int32 or tidx.dtype != torch.int32 or \
            pidx.dim() != 1 or pidx.shape != tidx.shape:
        raise ValueError("pidx/tidx must be int32 vectors of one length")


def _launch(peq_all, tiles, pidx, tidx, W: int, fmt: int, ncols: int):
    """[3, B] int32 from the pair kernel over the first `ncols` columns
    of the rows of `tiles` (format `fmt`), read in place through tidx:
    one launch, nothing allocated but the result (and, on the wide
    route past a CTA's shared memory, its scratch). Returns (result,
    whether the wide route ran)."""
    if peq_all.data_ptr() % 16:
        raise ValueError("peq_all must be 16-byte aligned")
    B = pidx.shape[0]
    out = torch.empty((3, B), dtype=torch.int32, device=pidx.device)
    wide = pair_wide(W, ncols)
    if B == 0:
        return out, wide
    lib = _build.load("myers_pairs", _SIG)
    stream = torch.cuda.current_stream(pidx.device).cuda_stream
    sms = sm_count(pidx.device)
    if wide:
        g = pair_wide_geometry(B, W, sms)
        scratch = torch.empty(g.scratch, dtype=torch.int32,
                              device=pidx.device)
        _build.launch(
            pidx.device, lib.myers_pairs_wide_launch, peq_all.data_ptr(),
            tiles.data_ptr(), pidx.data_ptr(), tidx.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if g.scratch else None, B,
            W, fmt, tiles.shape[1], ncols, peq_all.shape[0],
            tiles.shape[0], g.group, g.blocks, g.threads, g.smem, stream)
        return out, wide
    blocks, threads, smem = pair_geometry(B, W, sms)
    _build.launch(
        pidx.device, lib.myers_pairs_launch, peq_all.data_ptr(),
        tiles.data_ptr(), pidx.data_ptr(), tidx.data_ptr(), out.data_ptr(),
        B, W, fmt, tiles.shape[1], ncols, peq_all.shape[0], tiles.shape[0],
        blocks, threads, smem, stream)
    return out, wide


def myers_pairs_packed(peq_all: torch.Tensor, tiles_packed: torch.Tensor,
                       pidx: torch.Tensor, tidx: torch.Tensor, W: int
                       ) -> torch.Tensor:
    """K1: [3, B] (ed, first, last) of B gathered pairs over the
    nibble-packed store tiles_packed [NT, Lpb] (2 codes per byte, all
    2*Lpb columns scanned). peq_all [NQ, 16, W] int32 bits; pidx/tidx
    int32 [B], in range."""
    _check_inputs(peq_all, tiles_packed, pidx, tidx, W)
    if not tiles_packed.is_cuda:
        return myers_pairs_packed_plain(peq_all, tiles_packed, pidx,
                                        tidx, W)
    out, wide = _launch(peq_all, tiles_packed, pidx, tidx, W, FMT_PACKED,
                        2 * tiles_packed.shape[1])
    myers_pairs_packed.launches += int(pidx.shape[0] > 0)
    myers_pairs_packed.wide += int(pidx.shape[0] > 0 and wide)
    return out


myers_pairs_packed.launches = myers_pairs_packed.wide = 0


def myers_pairs(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                pidx: torch.Tensor, tidx: torch.Tensor, W: int
                ) -> torch.Tensor:
    """K2: [3, B] (ed, first, last) over tiles [NT, Lp] of one code per
    byte, any Lp and any row alignment: the kernel gathers the rows
    itself, all Lp columns scanned."""
    _check_inputs(peq_all, tiles_all, pidx, tidx, W)
    if not tiles_all.is_cuda:
        return myers_pairs_plain(peq_all, tiles_all, pidx, tidx, W)
    out, wide = _launch(peq_all, tiles_all, pidx, tidx, W, FMT_BYTES,
                        tiles_all.shape[1])
    myers_pairs.launches += int(pidx.shape[0] > 0)
    myers_pairs.wide += int(pidx.shape[0] > 0 and wide)
    return out


myers_pairs.launches = myers_pairs.wide = 0


def myers_cross(peq: torch.Tensor, tiles: torch.Tensor, W: int,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """K4: [Q, T] minimum glocal edit distance of every query against
    every tile over all Lp columns, as int32 or (out_dtype=torch.uint8)
    clipped at 255. peq [Q, C, W] int32 bits with C = 16 codes, or 256
    for raw-byte queries (`build_peq_x`), tiles [T, Lp] uint8 (one code
    per byte, trailing pad columns); any Q, T and Lp."""
    if tiles.device != peq.device:
        raise ValueError(f"tiles on {tiles.device}, peq on {peq.device}")
    if not peq.is_contiguous() or not tiles.is_contiguous():
        raise ValueError("peq and tiles must be contiguous")
    if W < 1:
        raise ValueError(f"W={W}: a query has at least one Myers word")
    if peq.dtype != torch.int32 or peq.dim() != 3 or \
            peq.shape[1] not in CROSS_CODES or peq.shape[2] != W:
        raise ValueError(f"peq must be int32 [Q, C, {W}] with C in "
                         f"{CROSS_CODES}, got {peq.dtype} "
                         f"{tuple(peq.shape)}")
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError("tiles must be a 2-D uint8 tensor")
    if out_dtype not in _CROSS_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the cross kernel writes "
                         "torch.int32 or torch.uint8")
    if not peq.is_cuda:
        return myers_cross_plain(peq, tiles, W, out_dtype)
    Q, (T, Lp) = peq.shape[0], tiles.shape
    if W > NARROW_W:
        return _cross_wide(peq, tiles, W, out_dtype)
    NQ, threads, (gx, gy) = cross_geometry(Q, T, W)
    if gy > CROSS_MAX_QGROUPS:
        raise ValueError(f"Q={Q}: over the launch grid's "
                         f"{CROSS_MAX_QGROUPS * NQ} queries per call")
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    if Q == 0 or T == 0:
        return out
    lib = _build.load("myers_cross", _SIG_CROSS)
    stream = torch.cuda.current_stream(peq.device).cuda_stream
    u8 = _CROSS_DTYPES[out_dtype]
    g = cross_thin_geometry(Q, T, W, Lp, peq.shape[1], bool(u8),
                            sm_count(peq.device))
    if g is not None:
        part = torch.empty(g.parts * Q * T if g.parts > 1 else 0,
                           dtype=torch.int32, device=peq.device)
        _build.launch(
            peq.device, lib.myers_cross_thin_launch, peq.data_ptr(),
            tiles.data_ptr(), out.data_ptr(),
            part.data_ptr() if g.parts > 1 else None, Q, T, W, Lp,
            peq.shape[1], g.nq, g.segments, g.seg, g.over, g.warps,
            *g.grid, g.smem, u8, stream)
        myers_cross.launches += 1
        myers_cross.thin += 1
        return out
    _build.launch(
        peq.device, lib.myers_cross_launch, peq.data_ptr(),
        tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp, peq.shape[1], NQ,
        threads, gx, gy, u8, stream)
    myers_cross.launches += 1
    return out


def _cross_wide(peq, tiles, W: int, out_dtype):
    """K4's wide routes (W > 16): one lane-group launch
    (`cross_group_geometry`), else one launch of one thread a pair, or
    where its Myers words take a global scratch, one launch per group of
    queries that keeps it under GLOBAL_SCRATCH bytes."""
    Q, (T, Lp) = peq.shape[0], tiles.shape
    if Q > CROSS_MAX_QGROUPS:
        raise ValueError(f"Q={Q}: over the launch grid's "
                         f"{CROSS_MAX_QGROUPS} queries per call")
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    if Q == 0 or T == 0:
        return out
    lib = _build.load("myers_cross", _SIG_CROSS)
    stream = torch.cuda.current_stream(peq.device).cuda_stream
    u8 = _CROSS_DTYPES[out_dtype]
    g = cross_group_geometry(Q, T, W, Lp, peq.shape[1], bool(u8),
                             sm_count(peq.device))
    if g is not None:
        _build.launch(
            peq.device, lib.myers_cross_group_launch, peq.data_ptr(),
            tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp, peq.shape[1],
            g.group, g.segments, g.seg, g.over, g.pairs, g.threads,
            *g.grid, g.smem, u8, stream)
        myers_cross.launches += 1
        myers_cross.wide += 1
        myers_cross.group += 1
        return out
    threads, (gx, _), smem, words = cross_wide_geometry(Q, T, W)
    per = Q if not words else max(1, GLOBAL_SCRATCH // (4 * words // Q))
    for q0 in range(0, Q, per):
        nq = min(per, Q - q0)
        scratch = torch.empty(words // Q * nq, dtype=torch.int32,
                              device=peq.device)
        _build.launch(
            peq.device, lib.myers_cross_wide_launch, peq[q0:].data_ptr(),
            tiles.data_ptr(), out[q0:].data_ptr(),
            scratch.data_ptr() if words else None, nq, T, W, Lp,
            peq.shape[1], threads, gx, nq, smem, u8, stream)
        myers_cross.launches += 1
        myers_cross.wide += 1
    return out


myers_cross.launches = myers_cross.wide = myers_cross.group = \
    myers_cross.thin = 0
