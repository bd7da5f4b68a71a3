"""Exact (slow) numpy oracle of the reference DP semantics.

These functions are literal re-expressions of the reference aligners:

* `edit_distance_glocal` -- the score-only "aded" semantics
  (the reference's burst.c:1003-1095): unit-cost glocal edit distance.
  The query is consumed end-to-end; the reference may begin and end
  anywhere (row 0 is all zeros; the result is the min over the last row,
  columns 1..len(ref)).

* `rescore` -- the tie-aware "reScoreM" semantics
  (the reference's burst.c:713-886): same DP, additionally carrying
  per-cell gap counters with the reference's exact dual-objective
  tiebreak (minimize edit distance; among ties maximize the number of
  query gaps, which maximizes BLAST identity = 1 - ED/(qlen + gapQ)),
  and reproducing its special-cased first row, the earliest-column
  selection of (gapQ, gapR) and the latest-column selection of finalPos.

They are the port's own exact oracle, a copy of `burst_tpu.kernels.refdp`:
the kernels' plain versions (kernels/myers.py, kernels/rescore.py), and
through them the CUDA kernels, are held to these in the tests.
"""
from __future__ import annotations

import numpy as np

from ..alphabet import score_matrix

_BIG = 1 << 28  # stands in for the saturated u8 255 ("dead") value


def _diag_costs(q: np.ndarray, r: np.ndarray, smat: np.ndarray) -> np.ndarray:
    """costs[y, x] for query letter y (0-based) vs ref letter x (0-based).

    255 entries (pad / never-match) are mapped to _BIG so that integer
    arithmetic preserves the reference's saturating-u8 "dead" semantics.
    """
    c = smat[q[:, None], r[None, :]].astype(np.int64)
    c[c == 255] = _BIG
    return c


def edit_distance_glocal(q: np.ndarray, r: np.ndarray,
                         smat: np.ndarray | None = None) -> int:
    """Min unit-cost glocal ED of query q (codes) vs reference r (codes)."""
    if smat is None:
        smat = score_matrix()
    m, L = len(q), len(r)
    cost = _diag_costs(q, r, smat)
    prev = np.zeros(L + 1, dtype=np.int64)  # row 0: free reference prefix
    for y in range(1, m + 1):
        base = np.minimum(prev[:-1] + cost[y - 1], prev[1:] + 1)
        cur = np.empty(L + 1, dtype=np.int64)
        cur[0] = y
        # cur[x] = min(base[x], cur[x-1] + 1): min-plus prefix scan
        shifted = np.minimum(base, _BIG)
        keys = np.concatenate(([cur[0]], shifted)) - np.arange(L + 1)
        run = np.minimum.accumulate(keys)
        cur[1:] = run[1:] + np.arange(1, L + 1)
        cur[0] = y
        prev = cur
    return int(min(prev[1:].min(), _BIG - 1)) if L else m


def rescore(q: np.ndarray, r: np.ndarray, max_ed: int,
            smat: np.ndarray | None = None):
    """Literal translation of RESCOREM_PROTYPE (burst.c:713-886).

    Returns dict with keys: ed, gap_q, gap_r, final_pos, score.
    `final_pos` is the 1-based reference column of the alignment end
    (rightmost among ties); `gap_q`/`gap_r` come from the leftmost tied
    column, exactly like the reference's sequential lane reduction.
    `score` is float32 identity 1 - ed/(qlen + gap_q).

    The DP is computed over the full matrix (no band); as proven in the
    design notes, band narrowing in the reference only masks cells whose
    value exceeds max_ed, which can never participate in any reported
    result, so results for any cell <= max_ed are identical.
    """
    if smat is None:
        smat = score_matrix()
    m, L = len(q), len(r)
    assert m >= 1 and L >= 1
    cost = _diag_costs(q, r, smat)
    bad = max_ed + 1  # scores >= bad are dead (masked to 255 in reference)

    def clamp(v):
        return np.minimum(v, _BIG)

    # Row 1 exactly as the reference's special first iteration
    # (burst.c:722-738): score = diag cost alone; gapQ=1 iff cost==1 and
    # the left neighbor's score is 0; gapR = 0.  Column 0 = (1, 0, 1).
    sc = np.empty(L + 1, dtype=np.int64)
    sh = np.zeros(L + 1, dtype=np.int64)   # gapQ counter per cell
    shr = np.zeros(L + 1, dtype=np.int64)  # gapR counter per cell
    sc[0], sh[0], shr[0] = 1, 0, 1
    sc[1:] = cost[0]
    left_sc = sc[:-1]
    sh[1:] = ((cost[0] == 1) & (left_sc == 0)).astype(np.int64)

    for y in range(2, m + 1):
        psc, psh, pshr = sc, sh, shr
        sc = np.empty(L + 1, dtype=np.int64)
        sh = np.empty(L + 1, dtype=np.int64)
        shr = np.empty(L + 1, dtype=np.int64)
        sc[0] = min(y, 255) if y < _BIG else y
        sh[0] = 0
        shr[0] = min(y, 255)
        for x in range(1, L + 1):
            # candidate O (diagonal)
            s, g, gr = psc[x - 1] + cost[y - 1][x - 1], psh[x - 1], pshr[x - 1]
            s = min(s, _BIG)
            # candidate U (up: consume query letter, gap in reference)
            sU, gU, grU = psc[x] + 1, psh[x], pshr[x] + 1
            sU = min(sU, _BIG)
            # merge O/U: smaller score wins; tie -> larger gapQ wins
            if sU < s or (sU == s and gU > g):
                s, g, gr = sU, gU, grU
            # candidate L (left: consume ref letter, gap in query)
            sL, gL, grL = sc[x - 1] + 1, sh[x - 1] + 1, shr[x - 1]
            sL = min(sL, _BIG)
            if sL < s or (sL == s and gL > g):
                s, g, gr = sL, gL, grL
            if s >= bad:
                s = _BIG  # reference: score |= 255 (dead)
            sc[x], sh[x], shr[x] = s, g, gr

    # Final lane reduction (burst.c:823-885): among columns 1..L pick
    # min score; among ties, max gapQ; (gapQ, gapR) from the earliest such
    # column, final_pos from the latest such column.
    best_s, best_g, best_gr = _BIG, 0, 0
    for x in range(1, L + 1):
        s, g = sc[x], sh[x]
        if s < best_s or (s == best_s and g > best_g):
            best_s, best_g, best_gr = s, g, shr[x]
    final_pos = 0
    for x in range(1, L + 1):
        if sc[x] == best_s and sh[x] == best_g:
            final_pos = x
    ed = min(best_s, 255)
    from ..native import score_identity
    score = score_identity(np.array([ed], np.float32),
                           np.array([m + best_g], np.float32))[0]
    return {"ed": int(ed), "gap_q": int(best_g), "gap_r": int(best_gr),
            "final_pos": int(final_pos), "score": np.float32(score)}
