"""K3's segment route: a pair's row past what one CTA's registers hold,
split into overlapping column windows on the register routes
(`rescore_seg_launch`) and the windows' partial results joined by the
merge kernel (`rescore_merge_launch`), both from csrc/rescore.cu itself
compiled for the CPU (tests/torch_cuda_emu.py), on the launch that
`rescore_geometry` / `rescore_segments` plan, against the plain
version `rescore_plain` over the whole row: exact equality (integer
DP), every pair, out-of-budget and dead ones included. Peq tables come
from burst_tpu's builders; inputs from numpy seeds."""
import ctypes
import os

import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers as jmyers
from burst_tpu_torch.kernels import _build, rescore_cuda
from burst_tpu_torch.kernels import rescore as prescore

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """csrc/rescore.cu built for the CPU: its segment and merge
    entries."""
    from tests import torch_cuda_emu
    src = open(os.path.join(_build.CSRC, "rescore.cu")).read()
    lib = torch_cuda_emu.build(torch_cuda_emu.emulate(src),
                               tmp_path_factory.mktemp("emu_segments"))
    return (torch_cuda_emu.entry(lib, "rescore_seg_launch",
                                 [_P] * 5 + [_I] * 18 + [_P]),
            torch_cuda_emu.entry(lib, "rescore_merge_launch",
                                 [_P] * 3 + [_I] * 3 + [_P]))


def _seg_case(seed, W, qlen, L1, codes, levels, kinds, own):
    """One pair a kind, each against its own tile of L1 - 1 columns
    (random codes, a pad tail of code 0 of 32 columns or more):
      "gap"   the query (letters of the alphabet's first half) cut
              across the first segment boundary (column `own`) with
              2^(levels-1) + 1 tile columns (letters of the second half)
              left out of its middle, straddling that boundary: its best
              alignment takes a left-gap chain that only the full
              window finds, one column longer than a look-back of one
              level less reaches (budget 250);
      "tie"   an exact copy of the query planted in the first segment
              and near the row's end, in another segment: the best
              score's first and last columns lie in different segments
              (budget 250);
      "spread" (levels 1, raw bytes) qlen distinct bytes, each one tile
              column apart in a tile of other bytes, ending just past
              the first segment boundary: the best alignment (qlen - 1
              gaps, the most gap_q at that score) leaves a column after
              each letter, a chain over 2 qlen columns, as wide a
              dependency as a look-back of 2 allows: a margin short of
              the cone (rows columns, say) misses it;
      "far"   an unrelated query under a budget of 3: out of budget,
              every cell of the last row DEAD;
      "zero"  a copy with one substitution under a budget of 0 (dead
              cells all along);
      "hit"   an exact copy under a budget of 0.
    Returns (peq [N, C W] int32, tiles, qmeta, rows)."""
    rng = np.random.default_rng(seed)
    alpha = PROTEIN if codes == 256 else np.arange(1, 5, dtype=np.uint8)
    N = len(kinds)
    n = L1 - 33
    tiles = np.zeros((N, L1 - 1), np.uint8)
    qs = np.zeros((N, 32 * W), np.uint8)
    qlens = np.zeros(N, np.int64)
    budget = np.zeros(N, np.int64)
    for i, kind in enumerate(kinds):
        tiles[i, :n] = alpha[rng.integers(0, len(alpha), n)]
        q = alpha[rng.integers(0, len(alpha), qlen)]
        budget[i] = {"far": 3, "zero": 0, "hit": 0}.get(kind, 250)
        if kind == "gap":
            half = len(alpha) // 2
            gap = (1 << levels - 1) + 1
            q = alpha[rng.integers(0, half, qlen)]
            st = own - gap // 2 - qlen // 2
            tiles[i, st:st + qlen + gap] = alpha[rng.integers(
                half, len(alpha), qlen + gap)]
            tiles[i, st:st + qlen // 2] = q[:qlen // 2]
            tiles[i, st + qlen // 2 + gap:st + qlen + gap] = q[qlen // 2:]
        elif kind == "spread":
            assert levels == 1 and codes == 256
            q = rng.permutation(np.arange(1, qlen + 1)).astype(np.uint8)
            st = own + 6 - 2 * qlen
            tiles[i, :n] = rng.integers(100, 200, n)
            tiles[i, st:st + 2 * qlen:2] = q
        elif kind in ("tie", "zero", "hit"):
            for st in (own // 3, n - qlen - 8) if kind == "tie" else \
                    (int(rng.integers(0, n - qlen)),):
                tiles[i, st:st + qlen] = q
            if kind == "zero":
                p = int(rng.integers(0, qlen))
                q[p] = alpha[(np.flatnonzero(alpha == q[p])[0] + 1)
                             % len(alpha)]
        qs[i, :qlen] = q
        qlens[i] = qlen
    if codes == 256:
        peq = jmyers.build_peq_x(qs, qlens, W)
    else:
        peq = jmyers.build_peq(qs, qlens, W, score_matrix())
    qmeta = np.stack([qlens, budget], 1).astype(np.int32)
    return (np.ascontiguousarray(peq.reshape(N, codes * W).view(np.int32)),
            tiles, qmeta, prescore.rows_for(qlens, W))


def _run(emu, peq, tiles, qmeta, W, codes, levels, rows, L1, tidx=None,
         Lt=None):
    """One emulated segment launch and its merge as `rescore` makes
    them; (its [4, N], the segments' part [5, N S], the split)."""
    seg, merge = emu
    N = len(qmeta)
    g = rescore_cuda.rescore_geometry(N, rows, L1, codes * W,
                                      levels=levels)
    sg = rescore_cuda.rescore_segments(N, rows, L1, codes * W,
                                       levels=levels)
    assert g.route == "segments" and sg.segs >= 2
    assert g == rescore_cuda.register_geometry(
        N * sg.segs, sg.window, codes * W, levels)._replace(route="segments")
    part = np.full((5, N * sg.segs), -7, np.int32)
    assert seg(peq.ctypes.data, tiles.ctypes.data,
               None if tidx is None else tidx.ctypes.data,
               qmeta.ctypes.data, part.ctypes.data, N, W, codes, levels,
               rows, L1, L1 - 1 if Lt is None else Lt, tiles.shape[1],
               sg.window, sg.own, sg.margin, sg.segs, g.cols, g.halo,
               g.pairs, g.threads, g.grid, g.smem, None) == 0
    out = np.full((4, N), -7, np.int32)
    assert merge(part.ctypes.data, qmeta.ctypes.data, out.ctypes.data, N,
                 sg.segs, rows, None) == 0
    np.testing.assert_array_equal(
        out, rescore_cuda.rescore_merge_plain(_t(part), _t(qmeta),
                                              rows).numpy())
    return out, part, sg


@pytest.mark.parametrize("W,qlen,L1,levels,codes,kinds", [
    (2, 60, 18048, 3, 16, ("gap", "tie", "far")),
    (2, 40, 40064, 2, 16, ("gap", "zero")),
    (2, 40, 18048, 1, 16, ("tie", "hit", "zero")),
    (2, 40, 18048, 1, 256, ("spread", "far")),
    (2, 40, 18048, 4, 256, ("gap", "far")),
    (2, 64, 18048, 5, 16, ("gap", "tie")),
    (3, 90, 18048, 6, 256, ("gap", "far")),
    (1, 20, 18048, 2, 16, ("tie", "zero", "far", "hit", "gap"))],
    ids=["L18k-lv3", "L40k-lv2", "lv1-dead", "lv1-spread-x256", "lv4-x256", "lv5", "lv6-x256",
         "warp-windows"])
def test_segment_kernel_source_on_cpu(emu, W, qlen, L1, levels, codes,
                                      kinds):
    """The segment route's kernel and merge, their own source compiled
    for the CPU, equal `rescore_plain` over the whole row exactly: just
    past the wide route's reach (18,048 columns) and at 40,064, look-back
    depths 1-6 (at 6 the margin passes a quarter of the window: the
    widest register window), 16 and 256 codes, windows on the wide route
    and, where the margin is short (up to levels 2 here), on the warp
    route. A left-gap chain across the
    first segment boundary is found (one level less finds a worse
    score), an alignment that leaves a column after every letter (a
    dependency over 2 qlen columns) is found past a boundary, a tie's
    best columns lie in two segments, and the pairs out of budget and
    under a budget of 0 (every cell DEAD) agree too."""
    sg = rescore_cuda.rescore_segments(len(kinds), prescore.rows_for(
        np.array([qlen]), W), L1, codes * W, levels=levels)
    peq, tiles, qmeta, rows = _seg_case(W * L1 + levels + codes, W, qlen,
                                        L1, codes, levels, kinds, sg.own)
    out, part, sg = _run(emu, peq, tiles, qmeta, W, codes, levels, rows,
                         L1)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    inner = rescore_cuda.register_geometry(1, sg.window, codes * W, levels)
    assert inner.route == ("warp" if sg.window <= 1024 else "wide")
    assert inner.route == ("warp" if levels <= 2 else "wide")
    assert sg.margin >= 1 + (rows - 1) * (1 << levels)
    per = part.reshape(5, len(kinds), sg.segs)
    for i, kind in enumerate(kinds):
        if kind in ("far", "zero"):
            assert ref[0, i] > qmeta[i, 1]
        elif kind == "hit":
            assert ref[0, i] == 0
        elif kind == "spread":      # ending at its planted column
            assert tuple(ref[:2, i]) == (qlen - 1, qlen - 1)
            assert ref[3, i] + (rows - qlen) == sg.own + 5
        elif kind == "tie":
            at = (per[0, i] == ref[0, i]) & (per[1, i] == ref[1, i])
            end = ref[3, i] + (rows - qlen)     # the last copy's column
            assert ref[0, i] == 0 and at[0] and at[(end - 1) // sg.own]
            assert (end - 1) // sg.own > 0 and at.sum() == 2
        elif kind == "gap" and levels > 1:
            less = prescore.rescore_plain(
                _t(peq[i:i + 1]), _t(tiles[i:i + 1]), _t(qmeta[i:i + 1]),
                W, levels - 1, rows, L1).numpy()
            assert less[0, 0] > ref[0, i] and ref[0, i] <= \
                (1 << levels - 1) + 2
            # the chain's alignment ends past the boundary: the segment
            # after it owns the best column, the chain in its margin
            assert ref[3, i] + (rows - qlen) > sg.own


def test_segment_kernel_reads_bucket_rows(emu):
    """With tile indices the segment kernel reads each pair's windows
    straight from bucket rows [NT, Lt] of a longer row stride (repeated
    and out-of-order rows; columns past Lt code 0): the same result as
    `rescore_plain` on the rows gathered and padded to L1 - 1, and as
    the wrapper's CPU version given the same indices."""
    W, qlen, L1, levels = 2, 50, 20096, 3
    sg = rescore_cuda.rescore_segments(4, 56, L1, 32, levels=levels)
    peq, tiles, qmeta, rows = _seg_case(77, W, qlen, L1, 16, levels,
                                        ("gap", "tie", "far"), sg.own)
    Lt = L1 - 1 - 200
    bucket = np.zeros((3, Lt + 64), np.uint8)      # row stride Lt + 64
    bucket[:, :Lt] = tiles[:, :Lt]
    bucket[:, Lt:] = 3                              # past Lt: never read
    tidx = np.array([2, 0, 2, 1], np.int64)
    pe = np.ascontiguousarray(peq[tidx])
    qm = np.ascontiguousarray(qmeta[tidx])
    out, _, _ = _run(emu, pe, bucket, qm, W, 16, levels, rows, L1,
                     tidx=tidx, Lt=Lt)
    gathered = np.zeros((4, L1 - 1), np.uint8)
    gathered[:, :Lt] = bucket[tidx, :Lt]
    ref = prescore.rescore_plain(_t(pe), _t(gathered), _t(qm), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    got = rescore_cuda.rescore(_t(pe), _t(bucket)[:, :Lt], _t(qm), W,
                               levels, rows, L1, tidx=_t(tidx))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("S", [1, 2, 33, 70])
def test_merge_kernel_source_on_cpu(emu, S):
    """The merge kernel alone, emulated, equals `rescore_merge_plain` on
    partial results full of ties: equal scores with other gap_q, equal
    (score, gap_q) in many segments (the first column decides gap_r, the
    last column final_pos), scores past 255 clipped, and more segments
    than a warp's lanes."""
    _, merge = emu
    rng = np.random.default_rng(S)
    N = 9
    s = rng.integers(0, 3, (N, S)) + np.where(np.arange(N) == 8, 509, 0)[
        :, None]
    g = rng.integers(0, 3, (N, S))
    first = np.sort(rng.choice(1 << 20, (N, S), replace=False), axis=1)
    first[:, 1:] = np.maximum(first[:, 1:], first[:, :-1] + 1)
    last = first + rng.integers(0, 5, (N, S))
    r = rng.integers(0, 200, (N, S))
    part = np.ascontiguousarray(np.stack([s, g, first, r, last]).reshape(
        5, N * S).astype(np.int32))
    qmeta = np.stack([rng.integers(50, 60, N), np.full(N, 9)],
                     1).astype(np.int32)
    out = np.full((4, N), -7, np.int32)
    assert merge(part.ctypes.data, qmeta.ctypes.data, out.ctypes.data, N, S,
                 64, None) == 0
    ref = rescore_cuda.rescore_merge_plain(_t(part), _t(qmeta), 64).numpy()
    np.testing.assert_array_equal(out, ref)
    assert ref[0, 8] == 255
    np.testing.assert_array_equal(
        rescore_cuda.rescore_merge(_t(part), _t(qmeta), 64).numpy(), ref)


def test_segment_launch_rejects_other_splits(emu):
    """The segment entry takes only a split whose margin covers the
    dependency cone (1 + (rows - 1) 2^levels columns), whose segments
    cover the row exactly, whose window is narrower than the row and its
    owned columns and margin inside it, and tile rows of at most L1 - 1
    columns within their stride; anything else is refused before a
    launch and nothing is written."""
    seg, _ = emu
    W, L1, levels, rows, N = 2, 18048, 3, 64, 2
    g = rescore_cuda.rescore_geometry(N, rows, L1, 32, levels=levels)
    sg = rescore_cuda.rescore_segments(N, rows, L1, 32, levels=levels)
    peq = np.zeros((N, 32), np.int32)
    tiles = np.zeros((N, L1 - 1), np.uint8)
    qmeta = np.array([[60, 5]] * N, np.int32)
    part = np.full((5, N * sg.segs), -7, np.int32)
    cone = 1 + (rows - 1) * (1 << levels)
    good = dict(sg._asdict(), Lt=L1 - 1, tstride=L1 - 1, rows=rows)
    own = sg.window - cone
    for bad in (dict(margin=cone - 1, own=own, segs=-(-(L1 - 1) // own)),
                dict(segs=sg.segs + 1), dict(segs=sg.segs - 1),
                dict(own=sg.own + 1), dict(Lt=L1), dict(tstride=L1 - 2),
                dict(rows=rows + 8), dict(window=L1)):
        a = dict(good, **bad)
        assert seg(peq.ctypes.data, tiles.ctypes.data, None,
                   qmeta.ctypes.data, part.ctypes.data, N, W, 16, levels,
                   a["rows"], L1, a["Lt"], a["tstride"], a["window"],
                   a["own"], a["margin"], a["segs"], g.cols, g.halo,
                   g.pairs, g.threads, g.grid, g.smem, None) != 0, bad
    assert (part == -7).all()


def test_segment_geometry():
    """`rescore_segments`: the margin is the cone rounded up to 32, each
    segment owns at least 4x its margin where the widest register window
    allows (the window then near SEG_WINDOW, smaller where the pairs
    would leave the card's SMs under SEG_FILL windows each), else the
    widest window while it owns a quarter of its columns; the segments
    cover L1 - 1 columns and one fewer would not; past that, and where
    one CTA holds the whole row, no split (the cluster route, or a
    register route)."""
    seg = rescore_cuda.rescore_segments
    reach = rescore_cuda.register_reach
    for N, rows, L1, pequ32, lv in ((2, 104, 240256, 64, 2),
                                    (8192, 152, 160128, 80, 3),
                                    (100, 304, 65536, 160, 4),
                                    (64, 1456, 65536, 736, 3),
                                    (1, 24, 18048, 16, 2)):
        sg = seg(N, rows, L1, pequ32, levels=lv)
        M = sg.margin
        assert M % 32 == 0 and M - 32 < 1 + (rows - 1) * (1 << lv) <= M
        assert sg.own == sg.window - 1 - M and sg.window % 32 == 0
        assert sg.window <= reach(pequ32, lv) and sg.window < L1
        assert sg.segs * sg.own >= L1 - 1 > (sg.segs - 1) * sg.own
        if 5 * M + 1 <= reach(pequ32, lv):
            assert sg.own >= 4 * M
            assert sg.window <= max(rescore_cuda.SEG_WINDOW, 5 * M + 32)
        else:
            assert sg.window == reach(pequ32, lv) and \
                4 * sg.own >= sg.window
    assert seg(2, 104, 240256, 64, levels=2) == (2112, 1695, 416, 142)
    assert seg(8192, 152, 160128, 80, levels=3).window == 6112
    assert seg(64, 1456, 65536, 736, levels=4) is None
    assert seg(64, 512, 65536, 736, levels=5) is None
    assert rescore_cuda.rescore_geometry(64, 1456, 65536, 736,
                                         levels=4).route == "cluster"
