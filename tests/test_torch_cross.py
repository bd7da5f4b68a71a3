"""Port parity for the dense cross scan (K4): `myers_cross_plain`, and
the `myers_cross` wrapper on CPU tensors, equal burst_tpu's jnp
`myers_min_ed_cross` at W in {1, 4, 10} on ragged Q/T with IUPAC codes
and trailing pad columns, and the Pallas kernel `myers_cross_pallas` in
interpret mode at one shape. All integers; tolerance 0."""
import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers as jmyers
from burst_tpu_torch.kernels import myers, myers_cuda

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


def _inputs(seed, W, Q, T, Lp, codes=16):
    """Queries of mixed lengths up to 32W over `codes` symbols, tiles of
    mixed lengths padded with code 0; every other query is cut from a
    tile with two substitutions, so small distances occur."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(max(2, 32 * W - 40), 32 * W + 1, Q)
    qs = np.zeros((Q, 32 * W), np.uint8)
    tiles = np.zeros((T, Lp), np.uint8)
    ulen = rng.integers(max(Lp // 2, 32 * W + 1), Lp - 8, T)
    for t in range(T):
        tiles[t, :ulen[t]] = rng.integers(1, codes, ulen[t])
    for q in range(Q):
        qs[q, :qlens[q]] = rng.integers(1, codes, qlens[q])
        if q % 2 == 0:
            t = int(rng.integers(0, T))
            n = int(min(qlens[q], ulen[t]))
            st = int(rng.integers(0, ulen[t] - n + 1))
            tiles[t, st:st + n] = rng.integers(1, 5, n)   # plain bases
            cut = tiles[t, st:st + n].copy()
            cut[rng.integers(0, n, 2)] = rng.integers(1, 5, 2)
            qs[q, :n] = cut
    peq = jmyers.build_peq(qs, qlens, W, score_matrix())
    return peq, tiles


@pytest.mark.parametrize("W,Q,T,Lp,codes", [
    (1, 13, 37, 70, 16), (4, 21, 130, 150, 16), (10, 9, 19, 347, 16),
    (4, 8, 128, 160, 5)],
    ids=["W1", "W4", "W10-amplicon", "W4-acgt"])
def test_cross_plain_matches_jnp(W, Q, T, Lp, codes):
    peq, tiles = _inputs(100 + W + Q, W, Q, T, Lp, codes)
    ref = np.asarray(jmyers.myers_min_ed_cross(peq, tiles, W))
    peq_t = torch.from_numpy(peq.view(np.int32))
    tiles_t = torch.from_numpy(tiles)
    got = myers.myers_cross_plain(peq_t, tiles_t, W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (Q, T)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() <= 3 and ref.max() > 10     # near and far pairs
    # the wrapper takes the plain version for CPU tensors, no launch
    before = myers_cuda.myers_cross.launches
    np.testing.assert_array_equal(
        myers_cuda.myers_cross(peq_t, tiles_t, W).numpy(), ref)
    assert myers_cuda.myers_cross.launches == before


def test_cross_plain_matches_pallas_interpret(monkeypatch):
    """The TPU kernel itself, interpreted on the CPU at its block shape
    (Q % 8 == 0, T % 128 == 0)."""
    from burst_tpu.kernels.myers_pallas import myers_cross_pallas

    monkeypatch.setenv("BURST_TPU_PALLAS_INTERPRET", "1")
    W, Q, T, Lp = 4, 8, 128, 144
    peq, tiles = _inputs(7, W, Q, T, Lp)
    ref = np.asarray(myers_cross_pallas(peq, tiles, W))
    got = myers.myers_cross_plain(torch.from_numpy(peq.view(np.int32)),
                                  torch.from_numpy(tiles), W)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cross_rows_match_pair_scan():
    """Row q of the cross block is the pair scan's min ED of query q
    against each tile (one recurrence behind K1/K2 and K4)."""
    W, Q, T, Lp = 2, 6, 11, 90
    peq, tiles = _inputs(3, W, Q, T, Lp)
    peq_t = torch.from_numpy(peq.view(np.int32))
    tiles_t = torch.from_numpy(tiles)
    cross = myers.myers_cross_plain(peq_t, tiles_t, W)
    pidx = torch.arange(Q, dtype=torch.int32).repeat_interleave(T)
    tidx = torch.arange(T, dtype=torch.int32).repeat(Q)
    pairs = myers.myers_pairs_plain(peq_t, tiles_t, pidx, tidx, W)
    np.testing.assert_array_equal(cross.numpy().ravel(), pairs[0].numpy())


@pytest.mark.parametrize("bad", ["W", "dtype", "shape", "contiguity"])
def test_cross_wrapper_rejects(bad):
    peq = torch.zeros((4, 16, 2), dtype=torch.int32)
    tiles = torch.zeros((5, 40), dtype=torch.uint8)
    if bad == "W":
        with pytest.raises(NotImplementedError, match="W=17"):
            myers_cuda.myers_cross(
                torch.zeros((4, 16, 17), dtype=torch.int32), tiles, 17)
    elif bad == "dtype":
        with pytest.raises(ValueError, match="int32"):
            myers_cuda.myers_cross(peq.long(), tiles, 2)
    elif bad == "shape":
        with pytest.raises(ValueError, match="2-D"):
            myers_cuda.myers_cross(peq, tiles[0], 2)
    else:
        with pytest.raises(ValueError, match="contiguous"):
            myers_cuda.myers_cross(peq, tiles[:, ::2], 2)
