"""Wrappers of the Myers kernels: the pair kernel
(`csrc/myers_pairs.cu`; K1 over the nibble-packed tile store, K2 over
tiles of one code per byte, one kernel family reading the rows in place)
and the dense cross kernel (`csrc/myers_cross.cu`; K4, int32 or uint8
clipped at 255, over Peq tables of 16 codes or, for raw-byte queries,
256). The launch geometry of each is pure Python
(`pair_geometry`, `cross_geometry`), so the CPU tests reach it.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version from `kernels.myers`. Each wrapper
counts its own launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .myers import (myers_cross_plain, myers_pairs_packed_plain,
                    myers_pairs_plain)

MAX_W = 16          # Myers words per query the kernels take (512 bp)
CROSS_CODES = (16, 256)       # K4: Peq codes, nucleotide or raw byte
CROSS_TILES_PER_CTA = 128     # K4: tiles per CTA at most, one per thread
CROSS_MAX_QGROUPS = 65535     # K4: query groups ride on grid.y
PAIR_SMEM_LIMIT = 48 * 1024   # static limit: no opt-in needed below it
FMT_PACKED, FMT_BYTES = 0, 1
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"myers_pairs_launch": [_P] * 5 + [_I] * 10 + [_P]}
_SIG_CROSS = {"myers_cross_launch": [_P, _P, _P] + [_I] * 10 + [_P]}
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
    and query groups on grid.y."""
    nq = 4 if W <= 4 else 2
    threads = min(CROSS_TILES_PER_CTA, max(32, -(-T // 32) * 32))
    return nq, threads, (-(-T // threads), -(-Q // nq))


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
    if not 1 <= W <= MAX_W:
        raise NotImplementedError(
            f"W={W}: the pair kernel takes W <= {MAX_W} (queries up to "
            f"{32 * MAX_W} bp; longer ones: ROADMAP, limits)")
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
    one launch, nothing allocated but the result."""
    if peq_all.data_ptr() % 16:
        raise ValueError("peq_all must be 16-byte aligned")
    if 32 * W + ncols >= 32768:
        raise ValueError(f"{ncols} tile columns: the kernel's packed "
                         "position keys hold scores under 32768")
    B = pidx.shape[0]
    out = torch.empty((3, B), dtype=torch.int32, device=pidx.device)
    if B == 0:
        return out
    blocks, threads, smem = pair_geometry(B, W, sm_count(pidx.device))
    err = _build.load("myers_pairs", _SIG).myers_pairs_launch(
        peq_all.data_ptr(), tiles.data_ptr(), pidx.data_ptr(),
        tidx.data_ptr(), out.data_ptr(), B, W, fmt, tiles.shape[1], ncols,
        peq_all.shape[0], tiles.shape[0], blocks, threads, smem,
        torch.cuda.current_stream(pidx.device).cuda_stream)
    _build.check(err, "myers_pairs_launch")
    return out


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
    out = _launch(peq_all, tiles_packed, pidx, tidx, W, FMT_PACKED,
                  2 * tiles_packed.shape[1])
    myers_pairs_packed.launches += int(pidx.shape[0] > 0)
    return out


myers_pairs_packed.launches = 0


def myers_pairs(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                pidx: torch.Tensor, tidx: torch.Tensor, W: int
                ) -> torch.Tensor:
    """K2: [3, B] (ed, first, last) over tiles [NT, Lp] of one code per
    byte, any Lp and any row alignment: the kernel gathers the rows
    itself, all Lp columns scanned."""
    _check_inputs(peq_all, tiles_all, pidx, tidx, W)
    if not tiles_all.is_cuda:
        return myers_pairs_plain(peq_all, tiles_all, pidx, tidx, W)
    out = _launch(peq_all, tiles_all, pidx, tidx, W, FMT_BYTES,
                  tiles_all.shape[1])
    myers_pairs.launches += int(pidx.shape[0] > 0)
    return out


myers_pairs.launches = 0


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
    if not 1 <= W <= MAX_W:
        raise NotImplementedError(
            f"W={W}: the cross kernel takes W <= {MAX_W} (queries "
            f"up to {32 * MAX_W} bp; longer ones: ROADMAP, limits)")
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
    NQ, threads, (gx, gy) = cross_geometry(Q, T, W)
    if gy > CROSS_MAX_QGROUPS:
        raise ValueError(f"Q={Q}: over the launch grid's "
                         f"{CROSS_MAX_QGROUPS * NQ} queries per call")
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    if Q == 0 or T == 0:
        return out
    err = _build.load("myers_cross", _SIG_CROSS).myers_cross_launch(
        peq.data_ptr(), tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp,
        peq.shape[1], NQ, threads, gx, gy, _CROSS_DTYPES[out_dtype],
        torch.cuda.current_stream(peq.device).cuda_stream)
    _build.check(err, "myers_cross_launch")
    myers_cross.launches += 1
    return out


myers_cross.launches = 0
