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
    # L1 = 2048 (past the block route's 1,024 columns) runs and equals
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
