"""The port's exact DP oracle (`burst_tpu_torch.kernels.refdp`) against
burst_tpu's, and the port's plain kernel versions against it: K4
(`myers_cross`) and K2 (`myers_pairs`) give its glocal edit distance, K3
(`rescore_pairs_gather`) its tie-aware (ed, gap_q, gap_r, final_pos)
inside the budget. Inputs from numpy seeds; tolerance is exact equality
(integer DP; the identity is the same float32 bits)."""
import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix as jscore_matrix
from burst_tpu.kernels import refdp as jrefdp
from burst_tpu_torch.alphabet import score_matrix
from burst_tpu_torch.kernels import myers, myers_cuda, refdp, rescore_cuda

torch.set_num_threads(2)


def _codes(rng, n, ambig):
    """n codes: A/C/G/T (1-4), or with `ambig` any of the 15 (N and the
    IUPAC codes among them)."""
    return rng.integers(1, 16 if ambig else 5, size=n).astype(np.uint8)


def _pairs(seed, n=12):
    """(query, reference) pairs: reads cut from their reference with a
    few substitutions, unrelated ones (no overlap to speak of), one-base
    queries and references, and codes with N where the seed says so."""
    rng = np.random.default_rng(seed)
    ambig = seed % 2 == 1
    out = []
    for i in range(n):
        r = _codes(rng, int(rng.integers(1, 90)), ambig)
        if i % 4 == 3 or len(r) < 4:
            q = _codes(rng, int(rng.integers(1, 40)), ambig)
        else:
            m = int(rng.integers(1, len(r) + 1))
            st = int(rng.integers(0, len(r) - m + 1))
            q = r[st:st + m].copy()
            for p in rng.integers(0, m, int(rng.integers(0, 4))):
                q[p] = 15 if ambig and p % 2 else int(rng.integers(1, 5))
        out.append((q, r))
    return out


@pytest.mark.parametrize("z", [1, 0])
@pytest.mark.parametrize("seed", range(4))
def test_edit_distance_matches_reference(seed, z):
    sm, jsm = score_matrix(z), jscore_matrix(z)
    np.testing.assert_array_equal(sm, jsm)
    for q, r in _pairs(seed):
        assert refdp.edit_distance_glocal(q, r, sm) == \
            jrefdp.edit_distance_glocal(q, r, jsm)
    # an empty reference: the whole query is inserted
    q = _pairs(seed)[0][0]
    assert refdp.edit_distance_glocal(q, q[:0], sm) == len(q) == \
        jrefdp.edit_distance_glocal(q, q[:0], jsm)


@pytest.mark.parametrize("max_ed", [0, 3, 40])
@pytest.mark.parametrize("seed", range(4))
def test_rescore_matches_reference(seed, max_ed):
    sm = score_matrix(seed % 2)
    for q, r in _pairs(seed, n=8):
        got = refdp.rescore(q, r, max_ed, sm)
        ref = jrefdp.rescore(q, r, max_ed, jscore_matrix(seed % 2))
        assert got.keys() == ref.keys()
        for k in ("ed", "gap_q", "gap_r", "final_pos"):
            assert got[k] == ref[k], (k, got, ref)
        assert np.float32(got["score"]).tobytes() == \
            np.float32(ref["score"]).tobytes()


def _batch(seed, W, NQ=6, NT=5, lb=192, pad=32):
    """Queries of W Myers words (32W - 31 to 32W codes, as the engine
    buckets them: the wildcard tail rows stay within the pad columns)
    cut from the tiles with a few substitutions (N and IUPAC codes among
    them), the last one random; tiles of one length bucket with `pad`
    trailing pad columns, as the engine's buckets."""
    rng = np.random.default_rng(seed)
    qs = np.zeros((NQ, 32 * W), np.uint8)
    qlens = rng.integers(32 * W - 31, 32 * W + 1, NQ)
    tiles = np.zeros((NT, lb + pad), np.uint8)
    tl = rng.integers(lb // 2, lb + 1, NT)
    for t in range(NT):
        tiles[t, :tl[t]] = _codes(rng, int(tl[t]), False)
    for i in range(NQ):
        src = tiles[i % NT, :tl[i % NT]]
        n = int(min(qlens[i], len(src)))
        qlens[i] = n
        st = int(rng.integers(0, len(src) - n + 1))
        q = src[st:st + n].copy()
        if i == NQ - 1:
            q = _codes(rng, n, True)
        for p in rng.integers(0, n, 3):
            q[p] = int(rng.integers(1, 16))
        qs[i, :n] = q
    return qs, qlens.astype(np.int64), tiles, tl


@pytest.mark.parametrize("W", [1, 2, 4])
def test_plain_kernels_match_oracle(W):
    smat = score_matrix()
    qs, qlens, tiles, tl = _batch(40 + W, W)
    NQ, NT = len(qs), len(tiles)
    peq = myers.build_peq_dev(torch.from_numpy(qs), torch.from_numpy(qlens),
                              torch.from_numpy(smat), W)
    ref = np.array([[refdp.edit_distance_glocal(qs[i, :qlens[i]],
                                                tiles[t, :tl[t]], smat)
                     for t in range(NT)] for i in range(NQ)])
    # K4: every query against every tile
    cross = myers_cuda.myers_cross(peq, torch.from_numpy(tiles), W)
    np.testing.assert_array_equal(cross.numpy(), ref)
    # K2: the same as gathered pairs
    pidx = np.repeat(np.arange(NQ), NT).astype(np.int32)
    tidx = np.tile(np.arange(NT), NQ).astype(np.int32)
    pairs = myers_cuda.myers_pairs(peq, torch.from_numpy(tiles),
                                   torch.from_numpy(pidx),
                                   torch.from_numpy(tidx), W)
    np.testing.assert_array_equal(pairs.numpy()[0], ref.ravel())
    # K3: (ed, gap_q, gap_r, final_pos) of the pairs inside the budget
    max_ed = np.full(len(pidx), 8, np.int64)
    out = rescore_cuda.rescore_pairs_gather(
        peq, torch.from_numpy(tiles), pidx, tidx, qlens[pidx], max_ed,
        W).numpy()
    want = [refdp.rescore(qs[i, :qlens[i]], tiles[t, :tl[t]], 8, smat)
            for i, t in zip(pidx, tidx)]
    ok = np.array([w["ed"] for w in want]) <= 8
    assert ok.sum() >= NQ - 1
    for row, key in zip(out, ("ed", "gap_q", "gap_r", "final_pos")):
        np.testing.assert_array_equal(
            row[ok], np.array([w[key] for w in want])[ok])
    assert (myers_cuda.myers_cross.launches, myers_cuda.myers_pairs.launches,
            rescore_cuda.rescore.launches) == (0, 0, 0)   # CPU: plain only
