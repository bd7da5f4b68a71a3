"""Phase-B tie-aware rescore DP: plain PyTorch version and its shape
arithmetic.

Counterpart of `burst_tpu.kernels.rescore` (`make_rescore`,
`_window_tiles`, `_levels_for`, the rows/L1/Lw arithmetic of
`rescore_pairs_gather_async`, `rescore_finalize_host`) and of the
Pallas kernel `burst_tpu.kernels.rescore_pallas._make_kernel`, whose
block contract it takes: per pair a Peq row [C*W], a tile of exactly
L1-1 columns and (qlen, max_ed); result (ed <= 255, gap_q, gap_r,
final_pos). The CUDA kernel (`csrc/rescore.cu`, wrapped by
`rescore_cuda`) must reproduce it bit for bit.

The DP runs over query rows 1..rows. A row's unit costs come from the
Peq bits (0 match, 1 mismatch, DEAD on pad columns); row 1 is special
cased like the reference. The diagonal/up merge prefers the lower
score, then the larger gap_q; the left-gap chain is a Hillis-Steele
prefix selection over keys ((s-x+Lp)<<32)|(GMASK-(g-x+Lp)) with payload
(x<<32)|shiftR, compared as int64, looking back exactly 2^levels
columns. Those are burst_tpu's 13- and 9-bit fields (the Pallas kernel
and the narrow jnp route) and its int32 planes compared in turn (the
wide route, past 511 rows or 7,679 columns) in one packing: each field
has 31 bits, so every shape orders the same way. A cell whose score
reaches max_ed+1 is DEAD.
"""
from __future__ import annotations

import numpy as np
import torch

DEAD = 511
M32 = 0xFFFFFFFF
GMASK = (1 << 31) - 1
NEG_INF_KEY = (1 << 62) | GMASK     # above every real key


def rows_for(qlens: np.ndarray, W: int) -> int:
    """DP rows: the batch's max query length rounded up to 8, at most
    32W (wildcard tail rows carry the row-qlen optimum down)."""
    if not len(qlens):
        return W * 32
    return min(W * 32, -(-int(qlens.max()) // 8) * 8)


def levels_for(max_ed: np.ndarray) -> int:
    """Hillis-Steele doublings covering a max(max_ed)+1 look-back."""
    need = int(max_ed.max()) + 2 if len(max_ed) else 2
    lv = 1
    while (1 << lv) < need:
        lv += 1
    return lv


def l1_for(lp_eff: int) -> int:
    """DP state width: the scanned columns plus column 0, rounded up to
    a multiple of 128."""
    return -(-(lp_eff + 1) // 128) * 128


def window_tiles(tiles: torch.Tensor, x0: torch.Tensor, Lw: int
                 ) -> torch.Tensor:
    """[B, Lw-1] column windows starting at x0; indices past the tile's
    end clamp to its last column, which is always a pad."""
    idx = x0.long()[:, None] + torch.arange(Lw - 1, device=tiles.device)
    idx = idx.clamp(0, tiles.shape[1] - 1)
    return tiles.gather(1, idx)


def rescore_plain(peq_flat: torch.Tensor, tiles: torch.Tensor,
                  qmeta: torch.Tensor, W: int, levels: int, rows: int,
                  L1: int) -> torch.Tensor:
    """[4, N] int32 (ed, gap_q, gap_r, final_pos). peq_flat [N, C*W]
    int32 bits (index c*W + w; C = 16, or 256 for raw bytes), tiles
    [N, L1-1] uint8 codes under C, qmeta [N, 2] int32 (qlen, max_ed)."""
    N = peq_flat.shape[0]
    Lp = L1 - 1
    dev = tiles.device
    codes = tiles.long()
    pad_col = codes == 0
    peq64 = peq_flat.long() & M32
    eq = [peq64.gather(1, codes * W + w) for w in range(W)]

    def cost_row(y: int):
        bit = (eq[(y - 1) // 32] >> ((y - 1) % 32)) & 1
        return torch.where(bit == 1, 0, torch.where(pad_col, DEAD, 1))

    bad = qmeta[:, 1].long()[:, None] + 1
    xs = torch.arange(L1, device=dev)[None, :]
    one = torch.ones((N, 1), dtype=torch.int64, device=dev)
    zero = torch.zeros((N, 1), dtype=torch.int64, device=dev)

    d1 = cost_row(1)
    sc = torch.cat([one, d1], dim=1)
    sh = torch.cat([zero, ((d1 == 1) & (sc[:, :-1] == 0)).long()], dim=1)
    shr = (xs == 0).long().expand(N, L1)
    sc = torch.where(sc >= bad, DEAD, sc)
    d_stop = min(L1, 1 << levels)
    for y in range(2, rows + 1):
        d = cost_row(y)
        sO = torch.clamp(sc[:, :-1] + d, max=DEAD + 1)
        sU = torch.clamp(sc[:, 1:] + 1, max=DEAD + 1)
        gO, gU = sh[:, :-1], sh[:, 1:]
        takeU = (sU < sO) | ((sU == sO) & (gU > gO))
        bs = torch.cat([one * y, torch.where(takeU, sU, sO)], dim=1)
        bg = torch.cat([zero, torch.where(takeU, gU, gO)], dim=1)
        br = torch.cat([one * y, torch.where(takeU, shr[:, 1:] + 1,
                                             shr[:, :-1])], dim=1)
        key = ((torch.clamp(bs, max=DEAD + 1) - xs + Lp) << 32) \
            | (GMASK - (bg - xs + Lp))
        pay = (xs << 32) | br
        d_shift = 1
        while d_shift < d_stop:
            ks = torch.cat([torch.full((N, d_shift), NEG_INF_KEY,
                                       dtype=torch.int64, device=dev),
                            key[:, :-d_shift]], dim=1)
            ps = torch.cat([torch.zeros((N, d_shift), dtype=torch.int64,
                                        device=dev),
                            pay[:, :-d_shift]], dim=1)
            better = (ks < key) | ((ks == key) & (ps > pay))
            key = torch.where(better, ks, key)
            pay = torch.where(better, ps, pay)
            d_shift <<= 1
        nsc = (key >> 32) - Lp + xs
        nsh = (GMASK - (key & GMASK)) - Lp + xs
        nshr = pay & M32
        nsc = torch.where(nsc >= bad, DEAD, nsc)
        nsc[:, 0] = y
        nsh[:, 0] = 0
        nshr[:, 0] = y
        sc, sh, shr = nsc, nsh, nshr

    s_last, g_last, r_last = sc[:, 1:], sh[:, 1:], shr[:, 1:]
    best_s = s_last.min(dim=1).values
    is_min = s_last == best_s[:, None]
    best_g = torch.where(is_min, g_last, -1).max(dim=1).values
    is_best = is_min & (g_last == best_g[:, None])
    colix = torch.arange(1, Lp + 1, device=dev)[None, :]
    first_col = torch.where(is_best, colix, 1 << 30).min(dim=1).values
    last_col = torch.where(is_best, colix, 0).max(dim=1).values
    best_r = torch.where(colix == first_col[:, None], r_last,
                         -(1 << 30)).max(dim=1).values
    final_pos = last_col - (rows - qmeta[:, 0].long())
    return torch.stack([torch.clamp(best_s, max=255), best_g, best_r,
                        final_pos]).to(torch.int32)


def rescore_finalize_host(ed, gq, gr, fp, qlens: np.ndarray):
    """Float32 identity on fetched arrays, with the reference binary's
    rounding (shared native `score_identity`)."""
    from ..native import score_identity
    score = score_identity(ed.astype(np.float32),
                           (qlens.astype(np.int64) + gq
                            ).astype(np.float32))
    return ed, gq, gr, fp, score
