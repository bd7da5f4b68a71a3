"""K3's cluster route: a pair's row held in the registers of a
thread-block cluster's CTAs (`rescore_cluster_launch`), the halo between
CTAs read from the previous CTA's shared memory, one cluster barrier a
row; past what a cluster holds, windows of its reach and the merge
kernel. csrc/rescore.cu itself compiled for the CPU
(tests/torch_cuda_emu.py: a cluster's CTAs run together, each with its
own shared buffer) against the plain version `rescore_plain` over the
whole row: exact equality (integer DP), every pair, out-of-budget and
dead ones included. Peq tables come from burst_tpu's Peq functions
(`tests/test_torch_segments._seg_case`); inputs from numpy seeds. Then
the planner's properties (`cluster_geometry`, `rescore_cluster`,
`rescore_geometry`) and the entry refusing launches it did not plan."""
import ctypes
import os

import numpy as np
import pytest
import torch

from burst_tpu_torch.kernels import _build, rescore_cuda
from burst_tpu_torch.kernels import rescore as prescore
from tests.test_torch_segments import _seg_case

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """csrc/rescore.cu built for the CPU: its cluster and merge entries."""
    from tests import torch_cuda_emu
    src = open(os.path.join(_build.CSRC, "rescore.cu")).read()
    lib = torch_cuda_emu.build(torch_cuda_emu.emulate(src),
                               tmp_path_factory.mktemp("emu_cluster"))
    return (torch_cuda_emu.entry(lib, "rescore_cluster_launch",
                                 [_P] * 5 + [_I] * 17 + [_P]),
            torch_cuda_emu.entry(lib, "rescore_merge_launch",
                                 [_P] * 3 + [_I] * 3 + [_P]))


def _plan(N, L, pequ32, levels, rows, cols, K, segs=1, own=None,
          margin=0):
    """The cluster launch of K CTAs a pair (or a window of L columns) at
    `cols` columns a thread, as `cluster_geometry` lays one out."""
    sb, gb, db, w = rescore_cuda.rescore_key_bits(L, levels, rows)
    kb = 32 if sb + gb + db <= 31 else 64
    halo = -(-w // cols)
    T = -(-L // ((32 - halo) * cols))
    nw = -(-T // K)
    assert -(-T // nw) == K, (T, nw, K)
    return rescore_cuda.ClusterLaunch(
        "cluster", 32 * nw, N * segs * K,
        rescore_cuda.rescore_wide_smem(nw, halo, cols, pequ32, kb=kb),
        cols, halo, K, kb, L, L - 1 if own is None else own, margin, segs)


def _launch(emu, g, peq, tiles, qmeta, W, codes, levels, rows, L1,
            tidx=None, Lt=None):
    """One emulated cluster launch `g` (and the merge of its windows):
    its [4, N]."""
    clu, merge = emu
    N = len(qmeta)
    part = np.full((4, N) if g.segs == 1 else (5, N * g.segs), -7,
                   np.int32)
    assert clu(peq.ctypes.data, tiles.ctypes.data,
               None if tidx is None else tidx.ctypes.data,
               qmeta.ctypes.data, part.ctypes.data, N, W, codes, levels,
               rows, L1, L1 - 1 if Lt is None else Lt, tiles.shape[1],
               g.window, g.own, g.margin, g.segs, g.cols, g.halo,
               g.threads // 32, g.cluster, g.smem, None) == 0
    if g.segs == 1:
        return part
    out = np.full((4, N), -7, np.int32)
    assert merge(part.ctypes.data, qmeta.ctypes.data, out.ctypes.data, N,
                 g.segs, rows, None) == 0
    return out


# (W, qlen, L1, levels, codes, columns a thread, CTAs, key bits, kinds):
# the kinds of `_seg_case`, their boundary the first column of CTA 1 (a
# left-gap chain and a tie across it), pairs out of budget and under a
# budget of 0
@pytest.mark.parametrize("W,qlen,L1,levels,codes,cols,K,kb,kinds", [
    (2, 40, 896, 3, 16, 8, 2, 32, ("gap", "tie", "far")),
    (2, 40, 960, 1, 256, 8, 4, 32, ("spread", "far", "zero")),
    (1, 24, 736, 2, 16, 8, 3, 32, ("tie", "hit", "zero", "gap")),
    (2, 40, 960, 4, 256, 8, 4, 32, ("gap", "far")),
    (2, 64, 1408, 5, 16, 16, 3, 32, ("gap", "tie", "hit")),
    (4, 100, 1920, 6, 16, 32, 2, 32, ("gap", "tie", "zero")),
    (1, 24, 4096, 9, 16, 32, 2, 64, ("tie", "far")),
    (2, 36, 8192, 8, 256, 16, 4, 64, ("tie", "zero")),
    (1, 16, 8192, 8, 256, 16, 4, 32, ("tie", "zero"))],
    ids=["K2-lv3", "K4-lv1-spread-x256", "K3-lv2-dead", "K4-lv4-x256",
         "K3-lv5-C16", "K2-lv6-C32", "key64-C32-lv9", "key64-C16-lv8",
         "rows-key32-lv8"])
def test_cluster_kernel_source_on_cpu(emu, W, qlen, L1, levels, codes, cols,
                                      K, kb, kinds):
    """The cluster kernel, its own source compiled for the CPU with the
    CTAs of a cluster run together, equals `rescore_plain` exactly: 2-4
    CTAs, look-back depths 1-9, 16 and 256 codes, 8, 16 and 32 columns a
    thread, 32-bit keys and keys past 31 bits (levels 8 and 9 at 4,096
    and 8,192 columns: the 64-bit instances), and a 32-bit key that only
    the rows' bound on gap_q allows (16 rows at levels 8 and 8,192
    columns: 1 + 15 x 255 under 2^12); a left-gap chain that only the
    full window finds and the copies of a tie lie across the first CTA
    boundary (the halo read from the previous CTA's shared memory, the
    final reduction across CTAs), pairs out of budget and under a budget
    of 0 agree too."""
    N = len(kinds)
    rows = prescore.rows_for(np.array([qlen]), W)
    g = _plan(N, L1, codes * W, levels, rows, cols, K)
    bound = (g.threads // 32) * (32 - g.halo) * cols   # CTA 1's first
    peq, tiles, qmeta, rows = _seg_case(W * L1 + levels + codes, W, qlen,
                                        L1, codes, levels, kinds, bound)
    sb, gb, db, _ = rescore_cuda.rescore_key_bits(L1, levels)
    assert g.kb == kb and (kb == 64 or sb + gb + db > 31 or levels < 8)
    out = _launch(emu, g, peq, tiles, qmeta, W, codes, levels, rows, L1)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    for i, kind in enumerate(kinds):
        end = ref[3, i] + (rows - qlen)     # the best alignment's column
        if kind in ("far", "zero"):
            assert ref[0, i] > qmeta[i, 1]
        elif kind == "hit":
            assert ref[0, i] == 0
        elif kind == "spread":
            assert tuple(ref[:2, i]) == (qlen - 1, qlen - 1)
            assert end == bound + 5
        elif kind == "tie":     # its first copy in CTA 0, its last past it
            assert ref[0, i] == 0 and end > bound
            assert ref[2, i] == 0
        elif kind == "gap" and levels > 1:
            less = prescore.rescore_plain(
                _t(peq[i:i + 1]), _t(tiles[i:i + 1]), _t(qmeta[i:i + 1]),
                W, levels - 1, rows, L1).numpy()
            assert less[0, 0] > ref[0, i]
            assert end > bound


@pytest.mark.parametrize("kind", ["rows", "bucket"])
def test_cluster_windows_source_on_cpu(emu, kind):
    """Past what a cluster holds: windows of Lw columns each owning Lw -
    1 - M after the dependency cone's margin M, one cluster (3 CTAs) a
    window, their partial results merged, equal `rescore_plain` over the
    whole row; a left-gap chain and a tie across the first window
    boundary. Also from bucket rows by tile index (repeated and out of
    order, columns past Lt code 0, a longer row stride)."""
    W, qlen, L1, levels, Lw = 1, 16, 2048, 2, 736
    rows = prescore.rows_for(np.array([qlen]), W)
    M = rescore_cuda.segment_margin(rows, levels)
    own = Lw - 1 - M
    segs = -(-(L1 - 1) // own)
    peq, tiles, qmeta, rows = _seg_case(91, W, qlen, L1, 16, levels,
                                        ("gap", "tie", "far", "zero"), own)
    tidx = Lt = None
    if kind == "bucket":
        Lt = L1 - 1 - 100
        bucket = np.zeros((4, Lt + 64), np.uint8)
        bucket[:, :Lt] = tiles[:, :Lt]
        bucket[:, Lt:] = 3                      # past Lt: never read
        tidx = np.array([3, 0, 3, 1, 2], np.int64)
        peq, qmeta = peq[tidx].copy(), qmeta[tidx].copy()
        tiles = np.zeros((5, L1 - 1), np.uint8)
        tiles[:, :Lt] = bucket[tidx, :Lt]
    N = len(qmeta)
    g = _plan(N, Lw, 16 * W, levels, rows, 8, 3, segs, own, M)
    out = _launch(emu, g, peq, tiles if tidx is None else bucket, qmeta, W,
                  16, levels, rows, L1, tidx, Lt)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert segs >= 3 and M >= 1 + (rows - 1) * (1 << levels)
    if kind == "rows":
        assert ref[3, 1] + (rows - qlen) > own and ref[0, 1] == 0
        assert ref[3, 0] + (rows - qlen) > own


def test_cluster_launch_rejects_other_geometry(emu):
    """The cluster entry takes only what `cluster_geometry` /
    `rescore_cluster` plan: another halo, warp count (one too many
    leaves the last CTA empty, one too few misses columns), cluster size
    (1, 17, or one more CTA than the columns need), shared-memory size,
    columns a thread without an instance at the key's width (8 a thread
    with a 64-bit key), a window whose margin is short of the cone or
    whose windows do not cover the row, a whole row with a margin, or
    tile rows longer than their stride; nothing is written."""
    clu, _ = emu
    N, W, L1, levels, rows = 2, 2, 1408, 5, 64
    peq = np.zeros((N, 32), np.int32)
    tiles = np.zeros((N, L1 - 1), np.uint8)
    qmeta = np.array([[60, 5]] * N, np.int32)
    out = np.full((5, 8 * N), -7, np.int32)
    good = dict(_plan(N, L1, 32, levels, rows, 16, 3)._asdict(),
                Lt=L1 - 1, tstride=L1 - 1, L1=L1, rows=rows)

    def call(a):
        return clu(peq.ctypes.data, tiles.ctypes.data, None,
                   qmeta.ctypes.data, out.ctypes.data, N, W, 16, levels,
                   a["rows"], a["L1"], a["Lt"], a["tstride"], a["window"],
                   a["own"], a["margin"], a["segs"], a["cols"], a["halo"],
                   a["threads"] // 32, a["cluster"], a["smem"], None)
    nw = good["threads"] // 32
    smem = lambda nw_, halo=good["halo"], kb=32, cols=16: \
        rescore_cuda.rescore_wide_smem(nw_, halo, cols, 32, kb=kb)
    bad = [dict(halo=3, smem=smem(nw, 3)),
           dict(threads=32 * (nw + 1), smem=smem(nw + 1)),
           dict(threads=32 * (nw - 1), smem=smem(nw - 1)),
           dict(cluster=1), dict(cluster=17), dict(cluster=4),
           dict(smem=good["smem"] + 4), dict(margin=32),
           dict(Lt=L1 - 1, tstride=L1 - 2)]
    # 8 columns a thread at a key past 31 bits (levels 9, 4,096 columns)
    g64 = _plan(N, 4096, 32, 9, rows, 32, 2)
    assert g64.kb == 64
    bad.append(dict(g64._asdict(), cols=8, halo=64,
                    smem=smem(g64.threads // 32, 64, 64, 8), L1=4096,
                    Lt=4095, tstride=4095))
    # windows (8 rows: a margin of 256): a margin short of the cone, a
    # split that misses columns
    M = rescore_cuda.segment_margin(8, levels)
    Lw = 1408
    wide = dict(good, L1=4 * Lw, Lt=L1 - 1, tstride=L1 - 1, margin=M,
                own=Lw - 1 - M, segs=-(-(4 * Lw - 1) // (Lw - 1 - M)),
                rows=8)
    ok = dict(wide)
    bad += [dict(wide, margin=M - 40, own=Lw - 1 - M + 40),
            dict(wide, segs=wide["segs"] - 1),
            dict(wide, own=wide["own"] + 1)]
    for b in bad:
        assert call(dict(good, **b)) != 0, b
    assert (out == -7).all()
    # the plans themselves run
    assert call(good) == 0 and call(ok) == 0


def test_cluster_geometry_covers_every_launch():
    """Every cluster launch the planner makes: 2 to `kmax` CTAs of nw
    warps whose own columns cover the row (or window) with the last CTA
    holding some, halo lanes that hold a look-back window (at most 16),
    the key of the window's fields (64 bits only at 16 or 32 columns a
    thread), threads within the instance's launch bound, shared memory
    as `rescore_wide_smem` counts it within SMEM_MAX, a grid of whole
    clusters over pairs x windows; windows own Lw - 1 - M columns after
    the cone's margin, a quarter of the window or more, and cover the
    row. Register and segment shapes keep their routes, and past them,
    at a card's 16 CTAs, every shape at a look-back of up to 64 takes the
    cluster route, and at 128-256 every one within a cluster's reach."""
    seen = set()
    for kmax in (16, 8):
        for L1 in [1024 * k for k in (18, 21, 30, 53, 90, 146, 160, 256,
                                      700)]:
            for levels in range(1, 9):
                for rows, pequ32, N in ((1456, 16 * 46, 2048),
                                        (1456, 16 * 46, 4),
                                        (512, 256 * 16, 512),
                                        (152, 16 * 5, 2048)):
                    g = rescore_cuda.rescore_geometry(
                        N, rows, L1, pequ32, levels=levels, kmax=kmax)
                    reg = rescore_cuda.register_geometry(N, L1, pequ32,
                                                         levels)
                    sg = rescore_cuda.rescore_segments(N, rows, L1, pequ32,
                                                       levels=levels)
                    assert (g.route in ("warp", "wide")) == (reg is not None)
                    if reg is None:
                        assert (g.route == "segments") == (sg is not None)
                    if g.route != "cluster":
                        assert g.route != "global" or kmax == 8 or (
                            levels >= 7 and L1 > rescore_cuda.cluster_reach(
                                pequ32, levels, kmax, rows))
                        continue
                    L = g.window
                    sb, gb, db, w = rescore_cuda.rescore_key_bits(L, levels,
                                                                  rows)
                    kb = 32 if sb + gb + db <= 31 else 64
                    nw, C, H, K = g.threads // 32, g.cols, g.halo, g.cluster
                    U = (32 - H) * C
                    assert g.kb == kb and (kb == 32 or C in (16, 32))
                    assert 2 <= K <= kmax and K * nw * U >= L > \
                        (K - 1) * nw * U
                    assert H == -(-w // C) <= rescore_cuda.WIDE_MAX_HALO
                    assert g.threads <= \
                        rescore_cuda.CLUSTER_MAX_THREADS[(C, kb)]
                    assert g.smem == rescore_cuda.rescore_wide_smem(
                        nw, H, C, pequ32, kb=kb) <= rescore_cuda.SMEM_MAX
                    assert g.grid == N * g.segs * K
                    if g.segs == 1:
                        assert (L, g.own, g.margin) == (L1, L1 - 1, 0)
                        assert L <= rescore_cuda.cluster_reach(
                            pequ32, levels, kmax, rows)
                    else:
                        cone = 1 + (rows - 1) * (1 << levels)
                        assert g.margin >= cone and \
                            g.own == L - 1 - g.margin and 4 * g.own >= L
                        assert g.segs * g.own >= L1 - 1 > \
                            (g.segs - 1) * g.own
                        assert L == rescore_cuda.cluster_reach(
                            pequ32, levels, kmax, rows) < L1
                    seen.add((C, kb, g.segs > 1))
    assert {(8, 32), (16, 32), (32, 32), (16, 64), (32, 64)} <= \
        {(c, b) for c, b, _ in seen} and any(s for *_, s in seen)


def test_cluster_route_shapes():
    """The shapes that took the global route before the cluster route
    (long reads rescored whole against long references) plan a cluster,
    alone or over windows: 1,450 bp reads (1,456 rows at a look-back of
    64) against a 21 kbp reference at 4 pairs, 2,048 against 30 and 150
    kbp, 1,000 against 262 kbp (windows of a cluster's reach, the merge),
    512 rows at 32, 1,456 rows at 16; a 64-bit key past 32,766 columns.
    The card's largest cluster bounds the plan (`kmax`, per instance:
    one it grants no cluster is never planned). Where even a cluster's
    windows would be mostly margin the band route takes the shape; the
    segment and cluster routes carry absolute columns to 2^27. What
    stays global: a look-back of 1,024 past 1,024 columns, L1 of 2^27 or
    more."""
    g = rescore_cuda.rescore_geometry
    for N, rows, L1, pequ32, lv in ((4, 1456, 21632, 736, 6),
                                    (2048, 1456, 30080, 736, 6),
                                    (2048, 1456, 149504, 736, 6),
                                    (512, 512, 30080, 256, 5),
                                    (512, 1456, 19072, 736, 4),
                                    (1000, 1456, 262144, 736, 6)):
        r = g(N, rows, L1, pequ32, levels=lv)
        assert r.route == "cluster", (N, rows, L1)
        assert (r.segs > 1) == (L1 == 262144)
        assert r.kb == (64 if L1 > 32766 else 32)
    assert g(1000, 1456, 262144, 736, levels=6).window == \
        rescore_cuda.cluster_reach(736, 6, rows=1456) == 184320
    assert rescore_cuda.cluster_reach(736, 6, 8, 1456) == 92160
    # at a look-back of 32, 1,456 rows bound gap_q to 45,106: a 32-bit
    # key at phase 14's longest genome
    assert g(256, 1456, 150784, 736, levels=5).kb == 32
    # a card that grants 8: the 150 kbp rows take windows of 92,160
    # columns, at most 8 CTAs; past them no window fits (the margin is
    # 93,152 columns): the band route, at most 8 CTAs a cluster
    r8 = g(2048, 1456, 149504, 736, levels=6, kmax=8)
    assert r8.route == "bands" and r8.cluster <= 8 and r8.band < 1456
    r8 = g(2048, 1456, 53248, 736, levels=6, kmax=8)
    assert r8.route == "cluster" and r8.cluster <= 8 and r8.segs == 1
    only = {inst: 0 for inst in rescore_cuda.CLUSTER_MAX_THREADS}
    only[(16, 32)] = 4
    r4 = g(4, 1456, 21632, 736, levels=6, kmax=only)
    assert (r4.cols, r4.cluster) == (16, 4)
    assert g(64, 300, 4096, 160, levels=10).route == "global"
    assert g(2, 60, 1 << 24, 64, levels=2).route == "segments"
    assert g(2, 60, 1 << 27, 64, levels=2).route == "global"


def test_cluster_wrapper_on_cpu():
    """`rescore` on CPU tensors at a cluster shape runs the plain
    version (bucket rows by tile index gathered and padded) and launches
    nothing: the card's route is planned only for CUDA tensors."""
    W, qlen, L1, levels = 1, 24, 20480, 6
    peq, tiles, qmeta, rows = _seg_case(5, W, qlen, L1, 16, levels,
                                        ("tie", "far"), 5000)
    assert rescore_cuda.rescore_geometry(
        2, 1456, L1, 16 * 46, levels=levels).route == "cluster"
    n0 = dict(rescore_cuda.rescore.routes)
    tidx = np.array([1, 0], np.int64)
    got = rescore_cuda.rescore(_t(peq[tidx]), _t(tiles), _t(qmeta[tidx]), W,
                               levels, rows, L1, tidx=_t(tidx))
    ref = prescore.rescore_plain(_t(peq[tidx]), _t(tiles[tidx]),
                                 _t(qmeta[tidx]), W, levels, rows, L1)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert rescore_cuda.rescore.routes == n0
