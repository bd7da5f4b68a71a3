"""Port parity: burst_tpu_torch's plain Myers pair scan (K1/K2) and its
helpers equal burst_tpu's jnp scan and the numpy host twin, bit for
bit. Inputs come from numpy seeds; tolerance is exact equality (all
integer arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers as jmyers
from burst_tpu.kernels.host import myers_pairs_np
from burst_tpu.kernels.myers_pallas import _words_from_packed
from burst_tpu.kernels.scour_device import _build_peq_dev
from burst_tpu_torch.kernels import myers, myers_cuda

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


def _pairs(seed, W, Lp, NQ=24, NT=16, B=40, tail=16):
    """Random queries with wildcard tails (qlen < 32W) and tiles with a
    trailing run of pad columns."""
    rng = np.random.default_rng(seed)
    smat = score_matrix()
    qs = rng.integers(1, 16, size=(NQ, W * 32)).astype(np.uint8)
    qlens = rng.integers(max(1, W * 32 - 40), W * 32 + 1,
                         size=NQ).astype(np.int64)
    peq = jmyers.build_peq(qs, qlens, W, smat)
    tiles = np.zeros((NT, Lp), np.uint8)
    ln = max(1, Lp - tail)
    tiles[:, :ln] = rng.integers(0, 16, size=(NT, ln))
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    return qs, qlens, peq, tiles, pidx, tidx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("W,Lp", [(1, 33), (2, 64), (3, 101), (4, 96),
                                  (5, 65), (6, 48), (7, 31), (8, 80)])
def test_pairs_plain_matches_jax(W, Lp):
    _, _, peq, tiles, pidx, tidx = _pairs(100 + W, W, Lp)
    ref = np.asarray(jmyers.myers_min_ed_gather_pos(
        jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    peq_t = _t(peq.view(np.int32))
    got = myers_cuda.myers_pairs(peq_t, _t(tiles), _t(pidx), _t(tidx), W)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        myers_pairs_np(peq, tiles, pidx, tidx, W), ref)
    # packed store (odd widths gain one trailing pad column)
    packed = jmyers.pack_nibbles_np(tiles)
    refp = np.asarray(jmyers.myers_min_ed_gather_pos_packed(
        jnp.asarray(peq), jnp.asarray(packed), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    gotp = myers_cuda.myers_pairs_packed(peq_t, _t(packed), _t(pidx),
                                         _t(tidx), W)
    np.testing.assert_array_equal(gotp.numpy(), refp)
    assert myers_cuda.myers_pairs.launches == 0      # CPU: plain only
    assert myers_cuda.myers_pairs_packed.launches == 0


@pytest.mark.parametrize("W", [1, 4])
def test_build_peq_dev_matches(W):
    qs, qlens, peq, _, _, _ = _pairs(7 + W, W, 64)
    smat = score_matrix()
    got = myers.build_peq_dev(_t(qs), _t(qlens), _t(smat), W)
    np.testing.assert_array_equal(got.numpy(), peq.view(np.int32))
    ref_dev = np.asarray(_build_peq_dev(jnp.asarray(qs),
                                        jnp.asarray(qlens),
                                        jnp.asarray(smat), W))
    np.testing.assert_array_equal(got.numpy(), ref_dev.view(np.int32))


@pytest.mark.parametrize("chunk", [1, 5, 24])
def test_build_peq_dev_in_chunks(chunk):
    """Built a few rows at a time (the last chunk ragged), the planes
    equal those built in one piece."""
    qs, qlens, peq, _, _, _ = _pairs(11, 4, 64)
    got = myers.build_peq_dev(_t(qs), _t(qlens), _t(score_matrix()), 4,
                              chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), peq.view(np.int32))


@pytest.mark.parametrize("Lpb", [8, 13, 240])
def test_pack_helpers_match(Lpb):
    rng = np.random.default_rng(Lpb)
    mat = rng.integers(0, 16, size=(5, 2 * Lpb - 1)).astype(np.uint8)
    pk = jmyers.pack_nibbles_np(mat)
    np.testing.assert_array_equal(myers.pack_nibbles(_t(mat)).numpy(), pk)
    np.testing.assert_array_equal(
        myers.unpack_nibbles(_t(pk)).numpy(),
        np.asarray(jmyers.unpack_nibbles(jnp.asarray(pk))))
    np.testing.assert_array_equal(
        myers.words_from_packed(_t(pk)).numpy(),
        np.asarray(_words_from_packed(jnp.asarray(pk))).view(np.int32))


def test_pairs_packed_pallas_interpret(monkeypatch):
    """One interpret-mode run of the Pallas K1 entry (B=1024, W=1) on
    the same inputs as the port's plain version."""
    from burst_tpu.kernels import myers_pallas
    monkeypatch.setenv("BURST_TPU_PALLAS_INTERPRET", "1")
    _, _, peq, tiles, pidx, tidx = _pairs(5, 1, 32, NQ=64, NT=32, B=1024,
                                          tail=8)
    packed = jmyers.pack_nibbles_np(tiles)
    ref = np.asarray(myers_pallas.myers_pairs_pallas_packed(
        jnp.asarray(peq), jnp.asarray(packed), jnp.asarray(pidx),
        jnp.asarray(tidx), 1))
    got = myers_cuda.myers_pairs_packed(_t(peq.view(np.int32)),
                                        _t(packed), _t(pidx), _t(tidx), 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrapper_rejects_bad_inputs():
    _, _, peq, tiles, pidx, tidx = _pairs(3, 2, 32)
    peq_t = _t(peq.view(np.int32))
    with pytest.raises(ValueError):
        myers_cuda.myers_pairs(peq_t, _t(tiles), _t(pidx.astype(np.int64)),
                               _t(tidx), 2)
    with pytest.raises(NotImplementedError):
        myers_cuda.myers_pairs(torch.zeros((1, 16, 9), dtype=torch.int32),
                               _t(tiles), _t(pidx), _t(tidx), 9)
