"""Wrappers of the Myers kernels: the pair kernel
(`csrc/myers_pairs.cu`; K1 over the nibble-packed tile store, K2 over
unpacked tiles) and the dense cross kernel (`csrc/myers_cross.cu`; K4).

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version from `kernels.myers`. Each wrapper
counts its own launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .myers import (myers_cross_plain, myers_pairs_packed_plain,
                    myers_pairs_plain, pack_nibbles)

MAX_W = 8           # Myers words per query the pair kernel takes
MAX_W_CROSS = 16    # ... and the cross kernel
CROSS_TILES_PER_CTA = 128
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"myers_pairs_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P]}
_SIG_CROSS = {"myers_cross_launch": [_P, _P, _P, _I, _I, _I, _I, _P]}


def _lib():
    return _build.load("myers_pairs", _SIG)


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
            f"{32 * MAX_W} bp)")
    if peq_all.dtype != torch.int32 or peq_all.dim() != 3 or \
            tuple(peq_all.shape[1:]) != (16, W):
        raise ValueError(f"peq_all must be int32 [NQ, 16, {W}], got "
                         f"{peq_all.dtype} {tuple(peq_all.shape)}")
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError("tiles must be a 2-D uint8 tensor")
    if pidx.dtype != torch.int32 or tidx.dtype != torch.int32 or \
            pidx.dim() != 1 or pidx.shape != tidx.shape:
        raise ValueError("pidx/tidx must be int32 vectors of one length")


def _launch(peq_all, packed, pidx, tidx, W: int, ncols: int):
    """[3, B] int32 from the kernel over a packed [NT, Lpb] store."""
    Lpb = packed.shape[1]
    if Lpb % 4 or packed.data_ptr() % 4:
        raise ValueError("packed tile rows must be 4-byte aligned "
                         f"(Lpb={Lpb})")
    B = pidx.shape[0]
    out = torch.empty((3, B), dtype=torch.int32, device=pidx.device)
    if B == 0:
        return out
    err = _lib().myers_pairs_launch(
        peq_all.data_ptr(), packed.data_ptr(), pidx.data_ptr(),
        tidx.data_ptr(), out.data_ptr(), B, W, Lpb, ncols,
        peq_all.shape[0], packed.shape[0],
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
    out = _launch(peq_all, tiles_packed, pidx, tidx, W,
                  2 * tiles_packed.shape[1])
    myers_pairs_packed.launches += int(pidx.shape[0] > 0)
    return out


myers_pairs_packed.launches = 0


def myers_pairs(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                pidx: torch.Tensor, tidx: torch.Tensor, W: int
                ) -> torch.Tensor:
    """K2: [3, B] (ed, first, last) over unpacked tiles [NT, Lp]. The
    gathered tiles are packed to nibble words in PyTorch, then scanned
    by the same kernel as K1 over exactly Lp columns."""
    _check_inputs(peq_all, tiles_all, pidx, tidx, W)
    if not tiles_all.is_cuda:
        return myers_pairs_plain(peq_all, tiles_all, pidx, tidx, W)
    Lp = tiles_all.shape[1]
    tiles = tiles_all[tidx.long()]
    pad = (-Lp) % 8                     # whole 4-byte words per row
    if pad:
        tiles = torch.nn.functional.pad(tiles, (0, pad))
    packed = pack_nibbles(tiles).contiguous()
    ident = torch.arange(pidx.shape[0], dtype=torch.int32,
                         device=pidx.device)
    out = _launch(peq_all, packed, pidx, ident, W, Lp)
    myers_pairs.launches += int(pidx.shape[0] > 0)
    return out


myers_pairs.launches = 0


def myers_cross(peq: torch.Tensor, tiles: torch.Tensor, W: int
                ) -> torch.Tensor:
    """K4: [Q, T] int32 minimum glocal edit distance of every query
    against every tile over all Lp columns. peq [Q, 16, W] int32 bits,
    tiles [T, Lp] uint8 (one code per byte, trailing pad columns); any Q,
    T and Lp."""
    if tiles.device != peq.device:
        raise ValueError(f"tiles on {tiles.device}, peq on {peq.device}")
    if not peq.is_contiguous() or not tiles.is_contiguous():
        raise ValueError("peq and tiles must be contiguous")
    if not 1 <= W <= MAX_W_CROSS:
        raise NotImplementedError(
            f"W={W}: the cross kernel takes W <= {MAX_W_CROSS} (queries "
            f"up to {32 * MAX_W_CROSS} bp; longer ones: ROADMAP, limits)")
    if peq.dtype != torch.int32 or peq.dim() != 3 or \
            tuple(peq.shape[1:]) != (16, W):
        raise ValueError(f"peq must be int32 [Q, 16, {W}], got "
                         f"{peq.dtype} {tuple(peq.shape)}")
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError("tiles must be a 2-D uint8 tensor")
    if not peq.is_cuda:
        return myers_cross_plain(peq, tiles, W)
    Q, (T, Lp) = peq.shape[0], tiles.shape
    if T > 65535 * CROSS_TILES_PER_CTA:
        raise ValueError(f"T={T}: over the launch grid's "
                         f"{65535 * CROSS_TILES_PER_CTA} tiles per call")
    out = torch.empty((Q, T), dtype=torch.int32, device=peq.device)
    if Q == 0 or T == 0:
        return out
    err = _build.load("myers_cross", _SIG_CROSS).myers_cross_launch(
        peq.data_ptr(), tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp,
        torch.cuda.current_stream(peq.device).cuda_stream)
    _build.check(err, "myers_cross_launch")
    myers_cross.launches += 1
    return out


myers_cross.launches = 0
