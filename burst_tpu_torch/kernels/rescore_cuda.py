"""Wrapper of the rescore kernel (`csrc/rescore.cu`, K3) and the
per-chunk gather that feeds it.

`rescore` launches the kernel for CUDA tensors (or raises) and runs
`rescore_plain` for CPU tensors; it counts its launches in its
`launches` attribute. `rescore_pairs_gather` is the counterpart of
`burst_tpu.kernels.rescore.rescore_pairs_gather_async`: it gathers each
pair's Peq row and tile (or tile window) in PyTorch, then calls
`rescore`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .rescore import l1_for, levels_for, rescore_plain, rows_for, \
    window_tiles

MAX_L1 = 1024     # one thread per DP column
MAX_ROWS = 511    # 9-bit shiftR payload field
_P = ctypes.c_void_p
_I = ctypes.c_int
RESCORE_CODES = (16, 256)   # Peq codes, nucleotide or raw byte
_SIG = {"rescore_launch": [_P, _P, _P, _P] + [_I] * 6 + [_P]}


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
    if not 1 <= rows <= min(MAX_ROWS, 32 * W):
        raise NotImplementedError(f"rows={rows} outside 1..{MAX_ROWS}")
    if L1 % 32 or not 32 <= L1 <= MAX_L1:
        raise NotImplementedError(
            f"L1={L1}: the rescore kernel takes a multiple of 32 up to "
            f"{MAX_L1} columns")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if not peq_flat.is_cuda:
        return rescore_plain(peq_flat, tiles, qmeta, W, levels, rows, L1)
    out = torch.empty((4, N), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    err = _build.load("rescore", _SIG).rescore_launch(
        peq_flat.data_ptr(), tiles.data_ptr(), qmeta.data_ptr(),
        out.data_ptr(), N, W, C, levels, rows, L1,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rescore_launch")
    rescore.launches += 1
    return out


rescore.launches = 0


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
