"""Port parity: burst_tpu_torch's plain rescore DP (K3) equals
burst_tpu's jnp rescore (`make_rescore_gather`'s fn and fn_win) and the
numpy host twin, bit for bit, windowed and full width, over Peq tables
of 16 codes and of 256 (raw-byte queries, `build_peq_x`). Inputs come
from numpy seeds; tolerance is exact equality (integer DP)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers as jmyers
from burst_tpu.kernels.host import rescore_pairs_np
from burst_tpu.kernels.rescore import make_rescore, make_rescore_gather
from burst_tpu_torch.kernels import rescore as prescore
from burst_tpu_torch.kernels import rescore_cuda

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _case(seed, W=4, NT=12, lb=128, P=48, qlen_lo=80, alpha=None):
    """Reads cut from the tiles with up to 3 substitutions or indels,
    a few unrelated ones; tiles padded like the engine's buckets
    (lb + 32W rounded up to 64). Codes 1-4, or with `alpha` raw bytes
    drawn from it under 256-code Peq tables."""
    rng = np.random.default_rng(seed)
    codes = np.arange(1, 5, dtype=np.uint8) if alpha is None else alpha

    class _Draw:
        @staticmethod
        def integers(lo, hi, n=None):
            return codes[rng.integers(0, len(codes), n)]
    smat = score_matrix()
    lp = -(-(lb + 32 * W) // 64) * 64
    tiles = np.zeros((NT, lp), np.uint8)
    ulen = rng.integers(lb - 40, lb + 1, NT)
    for t in range(NT):
        tiles[t, :ulen[t]] = _Draw.integers(1, 5, ulen[t])
    qs = np.zeros((P, 32 * W), np.uint8)
    qlens = rng.integers(qlen_lo, min(32 * W, lb - 40) + 1, P)
    tidx = rng.integers(0, NT, P).astype(np.int32)
    for i in range(P):
        src = tiles[tidx[i]]
        st = int(rng.integers(0, ulen[tidx[i]] - qlens[i] + 1))
        q = src[st:st + qlens[i]].copy()
        if i % 7 == 3:
            q = _Draw.integers(1, 5, qlens[i]).astype(np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            op = int(rng.integers(0, 3))
            if op == 0:
                q[p] = _Draw.integers(1, 5)
            elif op == 1 and len(q) > qlen_lo:
                q = np.delete(q, p)
            else:
                q = np.insert(q, p, _Draw.integers(1, 5))[:32 * W]
        qlens[i] = len(q)
        qs[i, :len(q)] = q
    if alpha is None:
        peq = jmyers.build_peq(qs, qlens.astype(np.int64), W, smat)
    else:
        peq = jmyers.build_peq_x(qs, qlens.astype(np.int64), W)
    pidx = np.arange(P, dtype=np.int32)
    max_ed = rng.integers(2, 6, P).astype(np.int64)
    return smat, peq, tiles, pidx, tidx, qlens.astype(np.int64), max_ed


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_ok(out, max_ed):
    """Pairs inside the budget, where the host twin's unbounded
    look-back is contractually identical."""
    return out[0] <= max_ed


@pytest.mark.parametrize("seed", [1, 2])
def test_full_width_matches_jax(seed):
    smat, peq, tiles, pidx, tidx, qlens, max_ed = _case(seed)
    W = 4
    fn, _ = make_rescore_gather(smat)
    rows = prescore.rows_for(qlens, W)
    lv = prescore.levels_for(max_ed)
    ref = np.asarray(fn(jnp.asarray(peq), jnp.asarray(tiles),
                        jnp.asarray(pidx), jnp.asarray(tidx),
                        jnp.asarray(qlens.astype(np.int32)),
                        jnp.asarray(max_ed.astype(np.int32)), W, lv, rows))
    got = rescore_cuda.rescore_pairs_gather(
        _t(peq.view(np.int32)), _t(tiles), pidx, tidx, qlens, max_ed, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    host = rescore_pairs_np(peq, tiles, pidx, tidx, qlens, max_ed, W,
                            rows)
    ok = _host_ok(ref, max_ed)
    assert ok.sum() > len(ok) // 2
    np.testing.assert_array_equal(got.numpy()[:, ok], host[:, ok])
    assert rescore_cuda.rescore.launches == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_windowed_matches_jax(seed):
    """The engine's window: x0 = first - 32W - bound - 1, Lw a multiple
    of 128 covering rows + bound + 2."""
    smat, peq, tiles, pidx, tidx, qlens, max_ed = _case(seed, lb=384)
    W = 4
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, tiles.shape[1] - 100, len(pidx)).astype(np.int64)
    rows = prescore.rows_for(qlens, W)
    Lw = -(-(rows + int(max_ed.max()) + 2) // 128) * 128
    _, fn_win = make_rescore_gather(smat)
    ref = np.asarray(fn_win(
        jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
        jnp.asarray(tidx), jnp.asarray(qlens.astype(np.int32)),
        jnp.asarray(max_ed.astype(np.int32)),
        jnp.asarray(x0.astype(np.int32)), W, Lw,
        prescore.levels_for(max_ed), rows))
    got = rescore_cuda.rescore_pairs_gather(
        _t(peq.view(np.int32)), _t(tiles), pidx, tidx, qlens, max_ed, W,
        x0=x0, Lw=Lw)
    np.testing.assert_array_equal(got.numpy(), ref)
    host = rescore_pairs_np(peq, tiles, pidx, tidx, qlens, max_ed, W,
                            rows, x0, Lw)
    ok = _host_ok(ref, max_ed)
    np.testing.assert_array_equal(got.numpy()[:, ok], host[:, ok])


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_levels_match_jax_core(levels):
    """Explicit look-back depths on one padded block: the kernel's
    contract (tiles of exactly L1-1 columns) through jnp's core."""
    smat, peq, tiles, pidx, tidx, qlens, max_ed = _case(10 + levels,
                                                        W=2, lb=128,
                                                        qlen_lo=40)
    W = 2
    L1 = prescore.l1_for(tiles.shape[1])
    tl = np.zeros((len(pidx), L1 - 1), np.uint8)
    tl[:, :tiles.shape[1]] = tiles[tidx]
    rows = prescore.rows_for(qlens, W)
    core = make_rescore(smat)
    ref = np.stack([np.asarray(o) for o in core(
        jnp.asarray(peq[pidx]), jnp.asarray(qlens.astype(np.int32)),
        jnp.asarray(tl), jnp.asarray(max_ed.astype(np.int32)), W,
        levels, rows)])
    qmeta = np.stack([qlens, max_ed], axis=1).astype(np.int32)
    got = rescore_cuda.rescore(
        _t(peq[pidx].reshape(len(pidx), 16 * W).view(np.int32)), _t(tl),
        _t(qmeta), W, levels, rows, L1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrapper_rejects_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        rescore_cuda.rescore(z((4, 64), dtype=torch.int32),
                             z((4, 100), dtype=torch.uint8),
                             z((4, 2), dtype=torch.int32), 4, 2, 8, 128)
    # L1 = 2048 (past the warp route's 1,024 columns) runs and equals
    # burst_tpu's jnp rescore at that width; rows past 32W are refused
    smat, peq, tiles, pidx, tidx, qlens, max_ed = _case(
        31, W=2, NT=4, lb=1900, P=5, qlen_lo=50)
    L1 = 2048
    tl = np.zeros((len(pidx), L1 - 1), np.uint8)
    tl[:, :tiles.shape[1]] = tiles[tidx]
    rows = prescore.rows_for(qlens, 2)
    levels = prescore.levels_for(max_ed)
    ref = np.stack([np.asarray(o) for o in make_rescore(smat)(
        jnp.asarray(peq[pidx]), jnp.asarray(qlens.astype(np.int32)),
        jnp.asarray(tl), jnp.asarray(max_ed.astype(np.int32)), 2, levels,
        rows)])
    qmeta = np.stack([qlens, max_ed], axis=1).astype(np.int32)
    got = rescore_cuda.rescore(
        _t(peq[pidx].reshape(len(pidx), 32).view(np.int32)), _t(tl),
        _t(qmeta), 2, levels, rows, L1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert rescore_cuda.rescore_geometry(len(pidx), rows, L1)[0] == "wide"
    with pytest.raises(ValueError, match="rows=72"):
        rescore_cuda.rescore(z((4, 32), dtype=torch.int32),
                             z((4, 2047), dtype=torch.uint8),
                             z((4, 2), dtype=torch.int32), 2, 2, 72, 2048)


@pytest.mark.parametrize("windowed", [False, True], ids=["full", "window"])
def test_xalpha_matches_jax(windowed):
    """256-code Peq tables (raw-byte queries, -x): the plain rescore
    equals burst_tpu's jnp rescore, whose Eq select then runs eight bit
    steps, full width and windowed; a table of another code count is
    refused."""
    smat, peq, tiles, pidx, tidx, qlens, max_ed = _case(
        21 + windowed, W=2, lb=256 if windowed else 128, qlen_lo=40,
        alpha=PROTEIN)
    W = 2
    assert peq.shape[1] == 256
    rows = prescore.rows_for(qlens, W)
    fn, fn_win = make_rescore_gather(smat)
    args = [jnp.asarray(a) for a in (peq, tiles, pidx, tidx,
                                     qlens.astype(np.int32),
                                     max_ed.astype(np.int32))]
    kw = {}
    if windowed:
        rng = np.random.default_rng(5)
        x0 = rng.integers(0, tiles.shape[1] - 100, len(pidx)).astype(
            np.int64)
        Lw = -(-(rows + int(max_ed.max()) + 2) // 128) * 128
        ref = np.asarray(fn_win(*args, jnp.asarray(x0.astype(np.int32)), W,
                                Lw, prescore.levels_for(max_ed), rows))
        kw = dict(x0=x0, Lw=Lw)
    else:
        ref = np.asarray(fn(*args, W, prescore.levels_for(max_ed), rows))
    got = rescore_cuda.rescore_pairs_gather(
        _t(peq.view(np.int32)), _t(tiles), pidx, tidx, qlens, max_ed, W,
        **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    if not windowed:           # random windows miss most alignments
        assert _host_ok(ref, max_ed).sum() > len(pidx) // 2
        assert (ref[0] == 0).any()
    with pytest.raises(ValueError):
        rescore_cuda.rescore(_t(np.zeros((4, 32 * W), np.int32)),
                             _t(np.zeros((4, 127), np.uint8)),
                             _t(np.zeros((4, 2), np.int32)), W, 1, 8, 128)


# ------------------------------------------- the kernel's own source

@pytest.fixture(scope="module")
def emulated_rescore(tmp_path_factory):
    """csrc/rescore.cu built for the CPU (tests/torch_cuda_emu.py): its
    entry, `rescore_wide_launch` (the register routes and the global
    route)."""
    import ctypes
    import os

    from burst_tpu_torch.kernels import _build
    from tests import torch_cuda_emu
    src = open(os.path.join(_build.CSRC, "rescore.cu")).read()
    lib = torch_cuda_emu.build(torch_cuda_emu.emulate(src),
                               tmp_path_factory.mktemp("emu_rescore"))
    return torch_cuda_emu.entry(lib, "rescore_wide_launch",
                                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                                + [ctypes.c_void_p])


def _wide_case(seed, W, qlen, L1, N, codes, budget, gap=0):
    """N queries of about qlen residues, each cut from its own tile of
    L1 - 1 columns (a pad tail of code 0, 32 columns or more) with a few
    substitutions and indels and, where `gap`, `gap` tile columns left
    out of its middle (its alignment then takes a left-gap chain that
    long in one row: found only where the look-back window is wider);
    every other pair an unrelated query. Peq tables of 16 codes or, with
    256, of raw bytes."""
    rng = np.random.default_rng(seed)
    alpha = PROTEIN if codes == 256 else np.arange(1, 5, dtype=np.uint8)
    half = len(alpha) // 2
    tiles = np.zeros((N, L1 - 1), np.uint8)
    qs = np.zeros((N, 32 * W), np.uint8)
    qlens = np.zeros(N, np.int64)
    for i in range(N):
        n = int(rng.integers(qlen + gap + 8, L1 - 32))
        tiles[i, :n] = alpha[rng.integers(0, len(alpha), n)]
        st = int(rng.integers(0, n - qlen - gap))
        if gap:     # the query's letters around the gap, others inside
            g0 = st + qlen // 2
            tiles[i, st:st + qlen + gap] = alpha[rng.integers(
                0, half, qlen + gap)]
            tiles[i, g0:g0 + gap] = alpha[rng.integers(half, len(alpha),
                                                       gap)]
        q = tiles[i, st:st + qlen + gap].copy()
        q = np.delete(q, np.arange(qlen // 2, qlen // 2 + gap))
        if i % 2 == 1:
            q = alpha[rng.integers(0, len(alpha), qlen)]
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            op = int(rng.integers(0, 3))
            if op == 0:
                q[p] = alpha[rng.integers(0, len(alpha))]
            elif op == 1:
                q = np.delete(q, p)
            else:
                q = np.insert(q, p, alpha[rng.integers(0, len(alpha))])
        q = q[:32 * W]
        qlens[i] = len(q)
        qs[i, :len(q)] = q
    if codes == 256:
        peq = jmyers.build_peq_x(qs, qlens, W)
    else:
        peq = jmyers.build_peq(qs, qlens, W, score_matrix())
    qmeta = np.stack([qlens, np.full(N, budget)], 1).astype(np.int32)
    return (np.ascontiguousarray(peq.reshape(N, codes * W).view(np.int32)),
            tiles, qmeta, prescore.rows_for(qlens, W))


@pytest.mark.parametrize("W,qlen,L1,levels,codes,N,budget", [
    (17, 520, 1152, 6, 16, 2, 15),   # 520 rows, a 64-column window over
    (17, 520, 1152, 6, 16, 2, 300),  # runs of 8 and across warps' edges
    (2, 60, 1280, 1, 16, 3, 250),
    (2, 60, 1280, 2, 256, 2, 250),
    (2, 60, 1152, 3, 256, 2, 250),
    (3, 90, 1536, 4, 16, 2, 250),
    (3, 90, 2176, 5, 16, 2, 250),
    (32, 296, 1024, 6, 256, 2, 250),  # one warp of 32 columns a lane
    (12, 360, 2048, 7, 16, 1, 250),  # 16 columns a lane, 8 halo lanes
    (20, 620, 2048, 8, 16, 1, 250)],  # 32 columns a lane across warps
    ids=["rows520-lv6", "rows520-lv6-gap48", "lv1", "lv2-x256",
         "lv3-x256", "lv4", "lv5", "one-warp-x256", "lv7-C16", "lv8-C32"])
def test_wide_kernel_source_on_cpu(emulated_rescore, W, qlen, L1, levels,
                                   codes, N, budget):
    """K3's wide route, its own source compiled for the CPU, equals
    `rescore_plain` exactly on the launch `rescore_geometry` plans: past
    511 rows and 1,024 columns, look-back depths 1-8 (windows wider than
    a thread's run of columns and crossing a warp's edge), 16 and 256
    codes, one warp and several, 8, 16 and 32 columns a thread. Where
    the budget allows, each near query leaves out 3/4 of a window of
    its tile (a left-gap chain that only the full window finds: the
    result differs from one level less)."""
    gap = 0 if budget < 20 else 3 * (1 << levels) // 4
    peq, tiles, qmeta, rows = _wide_case(W * L1 + levels, W, qlen, L1, N,
                                         codes, budget, gap)
    g = rescore_cuda.rescore_geometry(N, rows, L1, codes * W,
                                      levels=levels)
    assert g.route == ("warp" if W == 32 else "wide")
    if W == 17:
        assert rows > 511 and g.threads > 32 and g.cols < 1 << levels
    assert (g.threads == 32) == (W == 32)
    assert g.cols == {7: 16, 8: 32}.get(levels, 32 if W == 32 else 8)
    out = _run_register_route(emulated_rescore, peq, tiles, qmeta, W,
                              codes, levels, rows, L1, g)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    if gap > 1:
        less = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W,
                                      levels - 1, rows, L1).numpy()
        assert (less[0] > ref[0]).any() and (ref[0] <= gap + 6).any()
    assert (ref[0] <= min(budget, gap + 6)).any()
    if budget < 20:
        assert (ref[0] > budget).any()


def _run_register_route(emulated_rescore, peq, tiles, qmeta, W, codes,
                        levels, rows, L1, g):
    """One emulated launch `g` of the register routes; its [4, N]."""
    N = len(qmeta)
    out = np.zeros((4, N), np.int32)
    assert emulated_rescore(
        peq.ctypes.data, tiles.ctypes.data, qmeta.ctypes.data,
        out.ctypes.data, None, N, W, codes, levels, rows, L1, g.cols,
        g.halo, g.pairs, g.threads, g.grid, g.smem, None) == 0
    return out


@pytest.mark.parametrize("W,qlen,L1,levels,codes,N,budget,gap", [
    (4, 80, 128, 2, 16, 6, 3, 0),        # 4 columns a lane, 2 CTAs
    (10, 292, 384, 3, 16, 5, 9, 6),      # 12 a lane: the window in a run
    (10, 292, 384, 4, 16, 3, 30, 12),    # 16 a lane: the window is not
    (4, 100, 640, 2, 16, 3, 3, 0),       # 20 a lane
    (1, 30, 768, 1, 16, 3, 2, 0),        # 24 a lane, W = 1
    (2, 60, 896, 3, 256, 2, 250, 6),     # 28 a lane, raw bytes
    (3, 90, 256, 5, 16, 2, 250, 24),     # 8 a lane, doublings across lanes
    (10, 296, 1024, 4, 16, 2, 250, 12),  # 32 a lane
    (16, 500, 1024, 9, 256, 2, 300, 0),  # 500 rows, levels 9, raw bytes
    (16, 500, 1024, 10, 16, 2, 600, 0)],  # the 64-bit key
    ids=["L128-C4", "L384-C12", "L384-C16", "L640-C20", "L768-C24-W1",
         "L896-C28-x256", "L256-C8-lv5", "L1024-C32", "rows500-lv9-x256",
         "lv10-key64"])
def test_warp_route_source_on_cpu(emulated_rescore, W, qlen, L1, levels,
                                  codes, N, budget, gap):
    """K3's warp route (the shapes up to 511 rows and 1,024 columns that
    the first design's block route took), its own source compiled for
    the CPU, equals `rescore_plain` exactly on the launch
    `rescore_geometry` plans: one warp a pair and several pairs a CTA
    (the last CTA's spare warps idle), L1 / 32 columns a lane where the
    look-back window fits a lane's run (4 to 28: no idle lane), a power
    of two where it does not (doublings across lanes), look-back depths
    1-10, 16 and 256 codes; at L1 = 1,024 and levels 10 the fields take
    32 bits and the key 64. Where a gap is planted each near query
    leaves out 3/4 of a window of its tile, found only at the full
    depth."""
    peq, tiles, qmeta, rows = _wide_case(W * L1 + levels + codes, W, qlen,
                                         L1, N, codes, budget, gap)
    g = rescore_cuda.rescore_geometry(N, rows, L1, codes * W,
                                      levels=levels)
    sb, gb, db, w = rescore_cuda.rescore_key_bits(L1, levels)
    assert g.route == "warp" and g.halo == 0 and rows <= 511
    assert g.pairs == min(4, N) and g.grid == -(-N // g.pairs)
    assert g.cols == (L1 // 32 if w <= L1 // 32 else
                      1 << (L1 // 32 - 1).bit_length())
    assert (sb + gb + db > 31) == (levels == 10)
    out = _run_register_route(emulated_rescore, peq, tiles, qmeta, W,
                              codes, levels, rows, L1, g)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (ref[0] <= min(budget, gap + 6)).any()
    if gap > 1:
        less = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W,
                                      levels - 1, rows, L1).numpy()
        assert (less[0] > ref[0]).any()


def test_wide_launch_rejects_other_geometry(emulated_rescore):
    """The register routes' entry takes only the launch
    `rescore_geometry` plans: another halo, warp count, column count,
    pairs a CTA or shared-memory size is refused before a launch, and so
    are a run of 12 columns a lane shorter than the look-back window, a
    grid that misses pairs and a 32-bit key where the fields need 64;
    nothing is written."""
    N, W, L1, levels, rows = 1, 2, 1152, 3, 60
    peq, tiles, qmeta, _ = _wide_case(5, W, 60, L1, N, 16, 3)
    g = rescore_cuda.rescore_geometry(N, rows, L1, 16 * W, levels=levels)
    out = np.full((4, N), -7, np.int32)
    for bad in (dict(halo=g.halo + 1), dict(threads=g.threads + 32),
                dict(cols=32), dict(smem=g.smem + 4), dict(halo=0),
                dict(pairs=2, threads=2 * g.threads, grid=1)):
        a = dict(g._asdict(), **bad)
        assert emulated_rescore(
            peq.ctypes.data, tiles.ctypes.data, qmeta.ctypes.data,
            out.ctypes.data, None, N, W, 16, levels, rows, L1, a["cols"],
            a["halo"], a["pairs"], a["threads"], a["grid"], a["smem"],
            None) != 0, bad
    # the warp route: a window wider than a lane's run of 12 columns, a
    # grid short of the pairs
    for L1, lv, cols, n, grid in ((384, 4, 12, 4, 1), (384, 3, 12, 5, 1)):
        g = rescore_cuda.rescore_geometry(n, 60, L1, 16 * W, levels=lv)
        a = dict(g._asdict(), cols=cols, grid=grid)
        a["smem"] = rescore_cuda.rescore_wide_smem(
            1, 0, cols, 16 * W, a["pairs"])
        assert emulated_rescore(
            peq.ctypes.data, tiles.ctypes.data, qmeta.ctypes.data,
            out.ctypes.data, None, n, W, 16, lv, 60, L1, a["cols"], 0,
            a["pairs"], a["threads"], a["grid"], a["smem"], None) != 0, a
    assert (out == -7).all()
