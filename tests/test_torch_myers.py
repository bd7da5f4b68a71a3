"""Port parity: burst_tpu_torch's plain Myers pair scan (K1/K2) and its
helpers equal burst_tpu's jnp scan and the numpy host twin, bit for
bit. Inputs come from numpy seeds; tolerance is exact equality (all
integer arithmetic). Also, on the CPU, what of the CUDA pair kernel can
be held without a card: its fused column step, its walk over a tile row
(16-byte groups, unaligned rows, packed position keys, checked tail),
both written out in numpy, and its launch geometry."""
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
    # W = 17 (queries over 512 bp) runs in both tile formats and equals
    # burst_tpu's pair scan; a table of no words is refused
    W = myers_cuda.NARROW_W + 1
    _, _, peq, tiles, pidx, tidx = _pairs(4, W, 600, NQ=3, NT=4, B=6)
    ref = np.asarray(jmyers.myers_min_ed_gather_pos(
        jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    packed = jmyers.pack_nibbles_np(tiles)
    for fn, tl in ((myers_cuda.myers_pairs, tiles),
                   (myers_cuda.myers_pairs_packed, packed)):
        np.testing.assert_array_equal(
            fn(_t(peq.view(np.int32)), _t(tl), _t(pidx), _t(tidx),
               W).numpy(), ref)
        with pytest.raises(ValueError, match="W=0"):
            fn(torch.zeros((1, 16, 0), dtype=torch.int32), _t(tl),
               _t(pidx), _t(tidx), 0)


def _tie_pairs(seed, W, Lp, NQ=8, NT=8, B=48):
    """Inputs full of ties: homopolymer tiles, tiles that repeat their
    query several times, and queries that are homopolymers or periodic,
    so that many columns reach the minimum (first != last)."""
    rng = np.random.default_rng(seed)
    m = 32 * W
    qlens = rng.integers(max(1, m - 31), m + 1, size=NQ).astype(np.int64)
    qs = np.zeros((NQ, m), np.uint8)
    for i in range(NQ):
        period = (1, 2, 3, 7)[i % 4]
        qs[i] = np.resize(rng.integers(1, 5, period), m)
    qs[NQ - 1, rng.integers(0, m, 3)] = 15              # a few N rows
    tiles = np.zeros((NT, Lp), np.uint8)
    for t in range(NT):
        if t % 2:
            tiles[t] = 1 + t % 4                        # homopolymer
        else:
            tiles[t] = np.resize(qs[t % NQ, :qlens[t % NQ]], Lp)
    peq = jmyers.build_peq(qs, qlens, W, score_matrix())
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)      # with repeats
    return peq, tiles, pidx, tidx


@pytest.mark.parametrize("W,Lp", [(10, 350), (16, 530)])
def test_pairs_plain_matches_jax_wide_and_tied(W, Lp):
    """W = 10 (292 bp amplicon reads) and 16, on inputs full of ties."""
    peq, tiles, pidx, tidx = _tie_pairs(W, W, Lp)
    ref = np.asarray(jmyers.myers_min_ed_gather_pos(
        jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    assert (ref[1] != ref[2]).sum() > len(pidx) // 2     # ties are there
    peq_t = _t(peq.view(np.int32))
    got = myers_cuda.myers_pairs(peq_t, _t(tiles), _t(pidx), _t(tidx), W)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        myers_pairs_np(peq, tiles, pidx, tidx, W), ref)
    packed = jmyers.pack_nibbles_np(tiles)
    refp = np.asarray(jmyers.myers_min_ed_gather_pos_packed(
        jnp.asarray(peq), jnp.asarray(packed), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    gotp = myers_cuda.myers_pairs_packed(peq_t, _t(packed), _t(pidx),
                                         _t(tidx), W)
    np.testing.assert_array_equal(gotp.numpy(), refp)
    np.testing.assert_array_equal(gotp.numpy(), ref)     # Lp is even


def test_pairs_packed_pallas_interpret_tied(monkeypatch):
    """The interpret-mode Pallas K1 entry on inputs full of ties."""
    from burst_tpu.kernels import myers_pallas
    monkeypatch.setenv("BURST_TPU_PALLAS_INTERPRET", "1")
    peq, tiles, pidx, tidx = _tie_pairs(21, 1, 64, NQ=16, NT=16, B=1024)
    packed = jmyers.pack_nibbles_np(tiles)
    ref = np.asarray(myers_pallas.myers_pairs_pallas_packed(
        jnp.asarray(peq), jnp.asarray(packed), jnp.asarray(pidx),
        jnp.asarray(tidx), 1))
    assert (ref[1] != ref[2]).sum() > 256
    got = myers_cuda.myers_pairs_packed(_t(peq.view(np.int32)),
                                        _t(packed), _t(pidx), _t(tidx), 1)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- the CUDA pair kernel's arithmetic, written out in numpy

M32 = np.uint64(0xFFFFFFFF)


def _funnel_l1(lo, hi):
    """__funnelshift_l(lo, hi, 1): (hi << 1) | (lo >> 31)."""
    return ((hi << np.uint64(1)) & M32) | (lo >> np.uint64(31))


def _fused_column_np(eq, VP, VN):
    """The kernel's column step: one pass over the words, the sum's
    carry-out taken from a 64-bit sum, the shifted Ph/Mh taking their
    carry-in through a funnel shift, VP/VN ([n, W] uint64 holding u32)
    updated in place. Returns the score change."""
    W = VP.shape[1]
    carry = np.zeros(len(VP), np.uint64)
    ph_prev = np.zeros(len(VP), np.uint64)
    mh_prev = np.zeros(len(VP), np.uint64)
    for w in range(W):
        e, vp, vn = eq[:, w], VP[:, w].copy(), VN[:, w].copy()
        s = (e & vp) + vp + carry
        carry = s >> np.uint64(32)
        xh = ((s & M32) ^ vp) | e
        ph = vn | (~(xh | vp) & M32)
        mh = vp & xh
        xv = e | vn
        phs = _funnel_l1(ph_prev, ph)
        mhs = _funnel_l1(mh_prev, mh)
        ph_prev, mh_prev = ph, mh
        VP[:, w] = mhs | (~(xv | phs) & M32)
        VN[:, w] = phs & xv
    return (ph >> np.uint64(31)).astype(np.int64) - \
        (mh >> np.uint64(31)).astype(np.int64)


@pytest.mark.parametrize("W", [*range(1, 17), 17, 46])
def test_fused_column_equals_two_pass(W):
    """Random VP/VN/Eq states and the cases whose carry runs through
    every word (Eq and VP all ones, with and without one low bit), over
    a few chained columns."""
    rng = np.random.default_rng(900 + W)
    n = 256
    VP = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64)
    VN = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64) & ~VP & M32
    VP[:8], VN[:8] = M32, 0
    VP[8:16, 1:], VN[8:16] = M32, 0
    for step in range(4):
        eq = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64)
        eq[:4] = M32
        eq[4:8] = 1
        eq[8:12] = M32
        if W <= 16:
            tVP = [torch.from_numpy(VP[:, w].astype(np.int64))
                   for w in range(W)]
            tVN = [torch.from_numpy(VN[:, w].astype(np.int64))
                   for w in range(W)]
            teq = [torch.from_numpy(eq[:, w].astype(np.int64))
                   for w in range(W)]
            ref = myers._col_step(teq, tVP, tVN, W)
            tVP, tVN = torch.stack(tVP, 1), torch.stack(tVN, 1)
        else:     # past 16 words: every word in one tensor step
            tVP, tVN, ref = myers._col_step_wide(
                torch.from_numpy(eq.astype(np.int64)),
                torch.from_numpy(VP.astype(np.int64)),
                torch.from_numpy(VN.astype(np.int64)))
        got = _fused_column_np(eq, VP, VN)
        np.testing.assert_array_equal(got, ref.numpy())
        np.testing.assert_array_equal(VP.astype(np.int64), tVP.numpy())
        np.testing.assert_array_equal(VN.astype(np.int64), tVN.numpy())


def _pair_kernel_np(peq, mem, base, NT, rowbytes, ncols, pidx, tidx, W,
                    fmt):
    """The pair kernel's walk for every pair at once: `mem` is a byte
    buffer, the tile tensor its bytes [base, base + NT*rowbytes). Rows
    are read as 16-byte groups, one group ahead; a buffer that is not
    16-byte aligned goes through aligned 4-byte words and a funnel
    shift, with bytes outside the tensor never read. Eq words are
    fetched two columns ahead. Whole tile words run with packed position
    keys merged once per word, the columns of a last partial word in the
    checked loop."""
    C, BITS = (8, 4) if fmt == myers_cuda.FMT_PACKED else (4, 8)
    B = len(pidx)
    lo, hi = base, base + NT * rowbytes
    aligned = rowbytes % 16 == 0 and base % 16 == 0
    rows = base + tidx.astype(np.int64) * rowbytes
    touched = np.zeros(len(mem), bool)

    def byte(addr):
        ok = (addr >= lo) & (addr < hi)
        touched[addr[ok]] = True
        return np.where(ok, mem[np.clip(addr, 0, len(mem) - 1)], 0
                        ).astype(np.uint64)

    def word_at(addr):               # 4 bytes, little endian
        return sum(byte(addr + b) << np.uint64(8 * b) for b in range(4))

    nfull, rem = divmod(ncols, C)
    ngroups = (nfull + (rem != 0) + 3) >> 2

    def load_group(g):
        if g >= ngroups:
            return [np.zeros(B, np.uint64)] * 4
        if aligned:
            return [word_at(rows + 16 * g + 4 * i) for i in range(4)]
        mis = rows & 3
        a = rows - mis + 16 * g
        w = [word_at(a + 4 * i) for i in range(5)]
        sh = (8 * mis).astype(np.uint64)
        return [((w[i] | (w[i + 1] << np.uint64(32))) >> sh) & M32
                for i in range(4)]

    peq64 = peq.astype(np.uint64)[pidx]                    # [B, 16, W]
    take = lambda code: peq64[np.arange(B), code.astype(np.int64)]
    VP = np.full((B, W), M32, np.uint64)
    VN = np.zeros((B, W), np.uint64)
    score = np.full(B, 32 * W, np.int64)
    best, first, last = score.copy(), np.zeros(B, np.int64), \
        np.zeros(B, np.int64)
    BIG = np.int64(2**31 - 1)

    def merge(k1, k2, jb):
        nonlocal best, first, last
        wb = k1 >> 16
        first = np.where(wb < best, jb + 1 + (k1 & 0xFFFF), first)
        last = np.where(wb <= best, jb + C - (k2 & 0xFFFF), last)
        best = np.minimum(best, wb)

    q, n1 = load_group(0), load_group(1)
    word = q[0]
    # eq, e1: the Eq words of the column at hand and of the next one; the
    # column after that is fetched while the one at hand computes
    eq = take(word & np.uint64(15))
    e1 = take((word >> np.uint64(BITS)) & np.uint64(15))
    for wi in range(nfull):
        if wi & 3 == 3:
            q, n1 = n1, load_group((wi >> 2) + 2)
        else:
            q = q[1:] + [q[3]]
        nxt = q[0]
        k1, k2 = np.full(B, BIG), np.full(B, BIG)
        for sub in range(C):
            src = word if sub + 2 < C else nxt
            e2 = take((src >> np.uint64(BITS * ((sub + 2) % C)))
                      & np.uint64(15))
            score = score + _fused_column_np(eq, VP, VN)
            k1 = np.minimum(k1, score * 65536 + sub)
            k2 = np.minimum(k2, score * 65536 + (C - 1 - sub))
            eq, e1 = e1, e2
        merge(k1, k2, wi * C)
        word = nxt
    if rem:
        k1, k2 = np.full(B, BIG), np.full(B, BIG)
        word = word >> np.uint64(BITS)
        for sub in range(rem):
            word = word >> np.uint64(BITS)
            e2 = take(word & np.uint64(15))
            score = score + _fused_column_np(eq, VP, VN)
            k1 = np.minimum(k1, score * 65536 + sub)
            k2 = np.minimum(k2, score * 65536 + (C - 1 - sub))
            eq, e1 = e1, e2
        merge(k1, k2, nfull * C)
    assert not touched[:lo].any() and not touched[hi:].any()
    return np.stack([best, first, last]).astype(np.int32)


@pytest.mark.parametrize("W,Lp,base", [
    (1, 33, 0), (3, 101, 16), (4, 96, 32), (4, 100, 3), (8, 80, 16),
    (10, 347, 5), (16, 77, 2), (2, 7, 1), (5, 16, 16)])
def test_pair_kernel_walk_matches_plain(W, Lp, base):
    """The kernel's walk in numpy equals the plain versions, in both tile
    formats, at ragged widths, with rows at unaligned addresses, repeated
    tile indices, and the last row ending with the buffer."""
    if W * Lp > 1000:
        peq, tiles, pidx, tidx = _tie_pairs(W + Lp, W, Lp, B=24)
    else:
        _, _, peq, tiles, pidx, tidx = _pairs(300 + W, W, Lp)
    tidx[:2] = len(tiles) - 1, 0
    peq_t = _t(peq.view(np.int32))
    for fmt, store in ((myers_cuda.FMT_BYTES, tiles),
                       (myers_cuda.FMT_PACKED,
                        jmyers.pack_nibbles_np(tiles))):
        NT, rowbytes = store.shape
        mem = np.full(base + store.size, 0xEE, np.uint8)
        mem[base:] = store.ravel()
        if fmt == myers_cuda.FMT_BYTES:
            ref = myers.myers_pairs_plain(peq_t, _t(store), _t(pidx),
                                          _t(tidx), W)
            ncols = rowbytes
        else:
            ref = myers.myers_pairs_packed_plain(peq_t, _t(store), _t(pidx),
                                                 _t(tidx), W)
            ncols = 2 * rowbytes
        got = _pair_kernel_np(peq, mem, base, NT, rowbytes, ncols, pidx,
                              tidx, W, fmt)
        np.testing.assert_array_equal(got, ref.numpy())


def test_pair_geometry_covers_every_launch():
    """For every W and B from 1 to 2^22: the grid covers B, threads are
    whole warps, shared memory holds every thread's Peq table and stays
    within what a block can be given; small launches spread over the SMs
    and large ones take larger CTAs."""
    Bs = sorted({b for k in range(23) for b in
                 (2**k - 1, 2**k, 2**k + 1, 3 * 2**k // 2)
                 if 1 <= b <= 2**22} | set(range(1, 700)))
    for W in range(1, 17):
        for B in Bs:
            blocks, threads, smem = myers_cuda.pair_geometry(B, W)
            assert blocks * threads >= B > (blocks - 1) * threads
            assert threads % 32 == 0 and 32 <= threads <= 1024
            assert smem == threads * 64 * W
            assert smem <= myers_cuda.PAIR_SMEM_LIMIT <= 232448
            assert blocks < 2**31
    assert myers_cuda.pair_geometry(8192, 4) == (256, 32, 8192)
    assert myers_cuda.pair_geometry(16384, 4) == (512, 32, 8192)
    assert myers_cuda.pair_geometry(2**20, 4) == (8192, 128, 32768)
    assert myers_cuda.pair_geometry(2**20, 16) == (32768, 32, 32768)


# ------------------------------------- the wide kernel's own source

@pytest.fixture(scope="module")
def emulated_pairs(tmp_path_factory):
    """csrc/myers_pairs.cu built for the CPU (tests/torch_cuda_emu.py;
    the narrow kernels' add.cc / addc.cc as adds through an emulated
    carry flag): its wide entry, `myers_pairs_wide_launch`."""
    import ctypes
    import os

    from burst_tpu_torch.kernels import _build
    from tests import torch_cuda_emu
    src = open(os.path.join(_build.CSRC, "myers_pairs.cu")).read()
    for fn, cin in (("add_cc", ""), ("addc_cc", " + emu_cc")):
        src = torch_cuda_emu.replace_function(
            src, f"__device__ __forceinline__ uint32_t {fn}(uint32_t a, "
            "uint32_t b) ",
            "{\n  const uint64_t t = (uint64_t)a + b" + cin + ";\n"
            "  emu_cc = (uint32_t)(t >> 32);\n  return (uint32_t)t;\n}\n")
    lib = torch_cuda_emu.build(torch_cuda_emu.emulate(src, _build.CSRC),
                               tmp_path_factory.mktemp("emu_pairs"))
    return torch_cuda_emu.entry(lib, "myers_pairs_wide_launch",
                                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                                + [ctypes.c_void_p])


def _wide_pairs(seed, W, Lp, B, ripple=False):
    """Queries of 32W - 20 codes (fewer where the tiles are shorter),
    every other one cut from its tile with substitutions; tiles of Lp
    columns with a pad tail. `ripple`: every
    query one base and every tile a run of it, so that each column's sum
    carries through every word of every lane."""
    rng = np.random.default_rng(seed)
    NQ, NT = 3, 4
    qlen = min(32 * W - 20, Lp - 80)
    qs = np.zeros((NQ, 32 * W), np.uint8)
    tiles = np.zeros((NT, Lp), np.uint8)
    for t in range(NT):
        n = int(rng.integers(max(qlen + 8, Lp - 60), Lp - 4))
        tiles[t, :n] = 1 if ripple else rng.integers(1, 5, n)
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    for q in range(NQ):
        if ripple:
            qs[q, :qlen] = 1
            continue
        t = int(tidx[np.argmax(pidx == q)]) if (pidx == q).any() else 0
        st = int(rng.integers(0, Lp - 70 - qlen))
        qs[q, :qlen] = tiles[t, st:st + qlen]
        qs[q, rng.integers(0, qlen, 4)] = rng.integers(1, 5, 4)
        if q == NQ - 1:
            qs[q, :qlen] = rng.integers(1, 5, qlen)
    peq = jmyers.build_peq(qs, np.full(NQ, qlen, np.int64), W,
                           score_matrix())
    return peq, tiles, pidx, tidx


def _run_wide(emulated_pairs, peq, tiles, pidx, tidx, W, G, fmt,
              offset=0):
    """One emulated wide launch at G lanes a pair (1: the global-scratch
    variant) over tiles placed `offset` bytes past an aligned address."""
    B = len(pidx)
    store = tiles if fmt == myers_cuda.FMT_BYTES else \
        jmyers.pack_nibbles_np(tiles)
    mem = np.zeros(store.size + 16, np.uint8)
    mem[offset:offset + store.size] = store.ravel()
    out = np.zeros((3, B), np.int32)
    scratch = np.zeros(1, np.uint32)
    if G == 1:
        blocks, threads, smem = 2, 32, 0
        scratch = np.zeros(blocks * threads * 2 * W, np.uint32)
    else:
        K = next(k for k in myers_cuda.PAIR_WORDS if G * k >= W)
        threads = 128
        blocks, smem = -(-B * G // threads), threads * 64 * K
    peq32 = np.ascontiguousarray(peq.view(np.int32))
    ncols = store.shape[1] * (1 if fmt == myers_cuda.FMT_BYTES else 2)
    assert emulated_pairs(
        peq32.ctypes.data, mem.ctypes.data + offset, pidx.ctypes.data,
        tidx.ctypes.data, out.ctypes.data,
        scratch.ctypes.data if G == 1 else None, B, W, fmt,
        store.shape[1], ncols, len(peq), len(tiles), G, blocks, threads,
        smem, None) == 0
    plain = myers.myers_pairs_plain if fmt == myers_cuda.FMT_BYTES else \
        myers.myers_pairs_packed_plain
    return out, plain(_t(peq32), _t(store), _t(pidx), _t(tidx), W).numpy()


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("W,Lp,B,offset", [
    (17, 641, 5, 1), (33, 1131, 5, 0), (46, 1535, 5, 3), (64, 2101, 3, 2)])
def test_wide_kernel_source_on_cpu(emulated_pairs, W, Lp, B, offset, G):
    """K1/K2's wide route, its own source compiled for the CPU, equals
    the plain versions exactly at each lane-group size, in both tile
    formats, with rows of odd width at unaligned addresses, dead lanes
    past B and a pair whose query is unrelated to its tile."""
    peq, tiles, pidx, tidx = _wide_pairs(W * G + Lp, W, Lp, B)
    for fmt in (myers_cuda.FMT_BYTES, myers_cuda.FMT_PACKED):
        got, ref = _run_wide(emulated_pairs, peq, tiles, pidx, tidx, W, G,
                             fmt, offset)
        np.testing.assert_array_equal(got, ref)
    assert ref[0].min() <= 6 and ref[0].max() > 100


@pytest.mark.parametrize("W,Lp,B,G", [
    (46, 1500, 4, 8), (46, 1500, 4, 16), (33, 1100, 2, 32),
    (4, 32768 - 128, 2, 8), (920, 200, 3, 1)],
    ids=["ripple-G8", "ripple-G16", "ripple-G32", "W4-32640-columns",
         "W920-scratch"])
def test_wide_kernel_source_edges(emulated_pairs, W, Lp, B, G):
    """The wide route where a carry ripples through every lane of a group
    (a query of one base against a run of it), where a score passes the
    narrow kernel's 15-bit keys (W = 4, 32,640 columns: the geometry's
    G = 8, one word a lane), and past 28 words a lane (W = 920, one
    thread a pair, the words in a global scratch)."""
    ripple = Lp == 1500 or Lp == 1100
    peq, tiles, pidx, tidx = _wide_pairs(W + Lp, W, Lp, B, ripple=ripple)
    g = myers_cuda.pair_wide_geometry(B, W)
    assert myers_cuda.pair_wide(W, Lp)
    assert (g.group == 1) == (W == 920) and (W != 4 or g.group == G)
    fmts = (myers_cuda.FMT_BYTES,) if W == 4 else \
        (myers_cuda.FMT_BYTES, myers_cuda.FMT_PACKED)
    for fmt in fmts:
        got, ref = _run_wide(emulated_pairs, peq, tiles, pidx, tidx, W, G,
                             fmt)
        np.testing.assert_array_equal(got, ref)
    if ripple:
        assert (ref[0] == 0).all()


def test_wide_launch_rejects_other_geometry(emulated_pairs):
    """The wide entry refuses a lane group of another size, shared memory
    that does not match its words a lane, too few CTAs and a scratch
    beside a lane group, before a launch: nothing is written."""
    W, B = 46, 4
    peq, tiles, pidx, tidx = _wide_pairs(1, W, 1500, B)
    out = np.full((3, B), -7, np.int32)
    peq32 = np.ascontiguousarray(peq.view(np.int32))
    scratch = np.zeros(16, np.uint32)
    for G, blocks, threads, smem, scr in (
            (4, 1, 128, 128 * 64 * 12, None), (8, 1, 128, 128 * 64 * 5, None),
            (8, 0, 128, 128 * 64 * 6, None), (16, 1, 32, 32 * 64 * 3, None),
            (8, 1, 128, 128 * 64 * 6, scratch)):
        assert emulated_pairs(
            peq32.ctypes.data, tiles.ctypes.data, pidx.ctypes.data,
            tidx.ctypes.data, out.ctypes.data,
            None if scr is None else scr.ctypes.data, B, W,
            myers_cuda.FMT_BYTES, tiles.shape[1], tiles.shape[1], len(peq),
            len(tiles), G, blocks, threads, smem, None) != 0
    assert (out == -7).all()


def test_pair_wide_geometry_covers_every_launch():
    """For every W in 1..1,024 and B in {1, 31, 5,824, 2^18}: every pair
    is covered once (CTAs x threads / G lanes >= B, one CTA less would
    not), the words a lane hold W, the idle word slots stay at most a
    quarter where a lane group allows it, shared memory stays within
    what a CTA may opt into, and the planned state (VP, VN, Eq and the
    sum, K words each) within a thread's 255 registers; past 896 words
    one thread a pair over a global scratch of at most GLOBAL_SCRATCH
    bytes."""
    for W in range(1, 1025):
        for B in (1, 31, 5824, 1 << 18):
            g = myers_cuda.pair_wide_geometry(B, W)
            assert g.threads % 32 == 0 and 32 <= g.threads <= 1024
            if W > 896:
                assert g.group == 1 and g.smem == 0 and g.words == 0
                assert g.scratch == g.blocks * g.threads * 2 * W
                assert 4 * g.scratch <= myers_cuda.GLOBAL_SCRATCH
                continue
            G, K = g.group, g.words
            assert G in (8, 16, 32) and K in myers_cuda.PAIR_WORDS
            assert G * K >= W > G * max(
                [k for k in myers_cuda.PAIR_WORDS if k < K] or [0])
            per = g.threads // G
            assert g.blocks * per >= B > (g.blocks - 1) * per
            assert g.smem == g.threads * 64 * K <= 232448
            assert 4 * K + 24 <= 255
            if any(G2 * k2 >= W and (G2 * k2 - W) * 4 <= G2 * k2
                   for G2 in (8, 16, 32) for k2 in myers_cuda.PAIR_WORDS):
                assert (G * K - W) * 4 <= G * K
    assert myers_cuda.pair_wide_geometry(5824, 46)[:2] == (8, 6)
    assert myers_cuda.pair_wide_geometry(1 << 18, 46).threads == 128
