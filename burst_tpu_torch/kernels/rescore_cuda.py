"""Wrapper of the rescore kernel (`csrc/rescore.cu`, K3) and the
per-chunk gather that feeds it.

`rescore` launches the kernel for CUDA tensors (or raises) and runs
`rescore_plain` for CPU tensors; it counts its launches in its
`launches` attribute, and by route in `routes`, both routes of the row
in registers with packed look-back keys: "warp" (up to 1,024 columns:
one warp a pair, L1 / 32 columns a lane where the look-back window fits
a lane's run, several pairs a CTA), "wide" (one CTA of up to 32 warps a
pair, 8, 16 or 32 columns a thread, a halo between warps) and "global"
(threads striding over the columns, int64 keys, the row state in a
global scratch, past what one CTA's registers hold).
`rescore_geometry` picks the route and its launch shape in plain
Python. `rescore_pairs_gather` is the counterpart of
`burst_tpu.kernels.rescore.rescore_pairs_gather_async`: it gathers each
pair's Peq row and tile (or tile window) in PyTorch, then calls
`rescore`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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
_SIG = {"rescore_wide_launch": [_P] * 5 + [_I] * 12 + [_P]}


class RescoreLaunch(NamedTuple):
    """A K3 launch: its route ("warp", "wide" or "global"), threads per
    CTA, CTAs, dynamic shared-memory bytes (0 on the global route), on
    the register routes the columns a thread and the halo lanes a warp,
    and the pairs a CTA."""
    route: str
    threads: int
    grid: int
    smem: int
    cols: int = 0
    halo: int = 0
    pairs: int = 1


def rescore_key_bits(L1: int, levels: int) -> tuple[int, int, int, int]:
    """(score bits, gap_q bits, distance bits, window) of the register
    routes' look-back key at this shape: a candidate projected to the
    column it is compared at has a score of at most 512 + w - 1, a gap_q
    of at most L1 (one more than the column) and a distance under the
    window w = min(2^levels, L1); with the bit that marks a missing
    column they take a 32-bit key where they fit 31 bits, else a 64-bit
    one."""
    w = L1 if levels >= 30 else min(L1, 1 << levels)
    return (512 + w - 1).bit_length(), (L1 + 1).bit_length(), \
        (w - 1).bit_length(), w


def rescore_wide_smem(nw: int, halo: int, cols: int, pequ32: int,
                      pairs: int = 1) -> int:
    """Dynamic shared memory of a register-route launch: the halo
    exchange (two rows of H x C 32-bit keys and shiftR a warp; a 64-bit
    key runs one warp a pair, no halo), the final reduction (20 bytes a
    warp slot), and for each of its pairs the Peq table and one code
    byte a column slot."""
    return 2 * nw * halo * cols * 8 + 32 * 20 + \
        pairs * (4 * pequ32 + 32 * nw * cols)


def rescore_geometry(N: int, rows: int, L1: int, pequ32: int = 0,
                     sms: int = 132, levels: int = 1) -> RescoreLaunch:
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
    as before the warp route. Past them
    the global route at any L1 (no shared memory but the reduction's:
    the row state in a scratch of 32 bytes a column a CTA, the codes
    read from the tiles; one CTA per SM, fewer where the scratch would
    pass GLOBAL_SCRATCH bytes, walking over the pairs)."""
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
    if best is not None:
        return best[1]
    cap = GLOBAL_SCRATCH // (4 * 8 * L1)
    return RescoreLaunch("global", GLOBAL_THREADS,
                         max(1, min(N, sms, cap)), 0)


def rescore(peq_flat: torch.Tensor, tiles: torch.Tensor,
            qmeta: torch.Tensor, W: int, levels: int, rows: int,
            L1: int) -> torch.Tensor:
    """K3: [4, N] int32 (ed, gap_q, gap_r, final_pos). peq_flat
    [N, C*W] int32 bits (C = 16 codes, or 256 for raw-byte queries),
    tiles [N, L1-1] uint8, qmeta [N, 2] int32 (qlen, max_ed)."""
    N = peq_flat.shape[0]
    dev = peq_flat.device
    C = peq_flat.shape[1] // W if peq_flat.dim() == 2 else 0
    if C not in RESCORE_CODES:
        raise ValueError(f"peq_flat: expected [N, C*{W}] with C in "
                         f"{RESCORE_CODES}, got {tuple(peq_flat.shape)}")
    for name, t, dt, shape in (
            ("peq_flat", peq_flat, torch.int32, (N, C * W)),
            ("tiles", tiles, torch.uint8, (N, L1 - 1)),
            ("qmeta", qmeta, torch.int32, (N, 2))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
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
    if not peq_flat.is_cuda:
        return rescore_plain(peq_flat, tiles, qmeta, W, levels, rows, L1)
    out = torch.empty((4, N), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    g = rescore_geometry(N, rows, L1, C * W, sm_count(dev), levels)
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
rescore.routes = {"warp": 0, "wide": 0, "global": 0}


def rescore_pairs_gather(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                         pidx: np.ndarray, tidx: np.ndarray,
                         qlens: np.ndarray, max_ed: np.ndarray, W: int,
                         x0: np.ndarray | None = None,
                         Lw: int | None = None) -> torch.Tensor:
    """Rescore one chunk of pairs against device-resident Peq planes
    [NQ, C, W] and tiles [NT, Lt]; returns the [4, N] device result.

    With x0/Lw the DP runs on per-pair [Lw-1]-column windows starting
    at column x0 (final_pos is window-local: the caller adds x0 back);
    otherwise on the whole tile, padded to the kernel's L1-1 columns."""
    dev = peq_all.device
    rows = rows_for(qlens, W)
    L1 = l1_for(tiles_all.shape[1] if Lw is None else Lw - 1)
    pi = torch.from_numpy(np.asarray(pidx, dtype=np.int64)).to(dev)
    ti = torch.from_numpy(np.asarray(tidx, dtype=np.int64)).to(dev)
    peq = peq_all[pi].reshape(len(pidx), peq_all.shape[1] * W)
    tiles = tiles_all[ti]
    if x0 is not None:
        x0_d = torch.from_numpy(np.asarray(x0, dtype=np.int64)).to(dev)
        tiles = window_tiles(tiles, x0_d, L1)
    elif tiles.shape[1] < L1 - 1:
        tiles = torch.nn.functional.pad(tiles,
                                        (0, L1 - 1 - tiles.shape[1]))
    qmeta = torch.from_numpy(np.stack(
        [qlens.astype(np.int32), max_ed.astype(np.int32)], axis=1)
    ).to(dev)
    return rescore(peq.contiguous(), tiles.contiguous(), qmeta, W,
                   levels_for(max_ed), rows, L1)
