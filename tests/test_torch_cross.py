"""Port parity for the dense cross scan (K4): `myers_cross_plain`, and
the `myers_cross` wrapper on CPU tensors, equal burst_tpu's jnp
`myers_min_ed_cross` at W in {1, 4, 10} on ragged Q/T with IUPAC codes
and trailing pad columns, and the Pallas kernel `myers_cross_pallas` in
interpret mode at one shape; the uint8 result is that int32 one clipped
at 255. The same over 256-code Peq tables of raw-byte queries (`-x`,
`build_peq_x`), and the port's builds of those tables. The kernel's own
source, compiled for the CPU, at both code counts, each route: narrow,
wide, lane groups and thin (lanes across queries, column segments,
against burst_tpu's cross scan too). The launch geometries
(`cross_geometry`, `cross_group_geometry`, `cross_thin_geometry`) and
the engine's block plan (`cross_blocks`) are pure Python and held here
too. All integers; tolerance 0."""
import numpy as np
import pytest
import torch

from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers as jmyers
from burst_tpu_torch import engine
from burst_tpu_torch.kernels import myers, myers_cuda
from tests import torch_cuda_emu

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _inputs(seed, W, Q, T, Lp, codes=16):
    """Queries of mixed lengths up to 32W over `codes` symbols, tiles of
    mixed lengths padded with code 0; every other query is cut from a
    tile with two substitutions, so small distances occur. codes=256:
    raw protein bytes under 256-code Peq tables (`build_peq_x`)."""
    if codes == 256:
        return _inputs_x(seed, W, Q, T, Lp)
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


def _raw_queries(seed, W, Q, T, Lp):
    """Raw protein bytes: (qs, qlens, tiles) as `_inputs` makes them."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(max(2, 32 * W - 40), 32 * W + 1, Q)
    qs = np.zeros((Q, 32 * W), np.uint8)
    tiles = np.zeros((T, Lp), np.uint8)
    ulen = rng.integers(max(Lp // 2, 32 * W + 1), Lp - 8, T)
    for t in range(T):
        tiles[t, :ulen[t]] = PROTEIN[rng.integers(0, 20, ulen[t])]
    for q in range(Q):
        qs[q, :qlens[q]] = PROTEIN[rng.integers(0, 20, qlens[q])]
        if q % 2 == 0:
            t = int(rng.integers(0, T))
            n = int(min(qlens[q], ulen[t]))
            st = int(rng.integers(0, ulen[t] - n + 1))
            cut = tiles[t, st:st + n].copy()
            cut[rng.integers(0, n, 2)] = PROTEIN[rng.integers(0, 20, 2)]
            qs[q, :n] = cut
    return qs, qlens, tiles


def _inputs_x(seed, W, Q, T, Lp):
    qs, qlens, tiles = _raw_queries(seed, W, Q, T, Lp)
    return jmyers.build_peq_x(qs, qlens, W), tiles


@pytest.mark.parametrize("W,Q,T,Lp,codes", [
    (1, 13, 37, 70, 16), (4, 21, 130, 150, 16), (10, 9, 19, 347, 16),
    (4, 8, 128, 160, 5), (2, 11, 41, 120, 256), (5, 6, 17, 230, 256)],
    ids=["W1", "W4", "W10-amplicon", "W4-acgt", "W2-xalpha",
         "W5-xalpha"])
def test_cross_plain_matches_jnp(W, Q, T, Lp, codes):
    peq, tiles = _inputs(100 + W + Q, W, Q, T, Lp, codes)
    ref = np.asarray(jmyers.myers_min_ed_cross(peq, tiles, W))
    peq_t = torch.from_numpy(peq.view(np.int32))
    tiles_t = torch.from_numpy(tiles)
    got = myers.myers_cross_plain(peq_t, tiles_t, W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (Q, T)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() <= 3 and ref.max() > 10     # near and far pairs
    assert peq.shape[1] == (256 if codes == 256 else 16)
    # the wrapper takes the plain version for CPU tensors, no launch
    before = myers_cuda.myers_cross.launches
    np.testing.assert_array_equal(
        myers_cuda.myers_cross(peq_t, tiles_t, W).numpy(), ref)
    assert myers_cuda.myers_cross.launches == before


@pytest.mark.parametrize("W", [1, 3])
def test_build_peq_x_matches_jnp(W):
    """256-code tables: the port's `build_peq_x` and its device build
    (`build_peq_dev` from `xalpha_smat`, in chunks) equal burst_tpu's
    `build_peq_x`, wildcard tail rows included."""
    qs, qlens, _ = _raw_queries(50 + W, W, 37, 8, 200)
    ref = jmyers.build_peq_x(qs, qlens, W)
    np.testing.assert_array_equal(myers.build_peq_x(qs, qlens, W), ref)
    dev = myers.build_peq_dev(
        torch.from_numpy(qs), torch.from_numpy(qlens),
        torch.from_numpy(myers.xalpha_smat()), W, chunk=16)
    assert tuple(dev.shape) == (37, 256, W)
    np.testing.assert_array_equal(dev.numpy(), ref.view(np.int32))


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


@pytest.mark.parametrize("W,Q,T,Lp", [(10, 7, 23, 700), (16, 3, 9, 600)])
def test_cross_uint8_clips_at_255(W, Q, T, Lp):
    """out_dtype=torch.uint8 is min(ed, 255) of the int32 result, exactly:
    long queries of code 5 (which matches no tile code) have distances
    over 255, the others (cut from a tile) small ones."""
    peq, tiles = _inputs(40 + W, W, Q, T, Lp)
    qs = np.full((Q, 32 * W), 5, np.uint8)
    far = jmyers.build_peq(qs, np.full(Q, 32 * W - 3), W, score_matrix())
    peq[1::2] = far[1::2]
    ref = np.asarray(jmyers.myers_min_ed_cross(peq, tiles, W))
    assert ref.max() > 255 and ref.min() <= 3
    peq_t = torch.from_numpy(peq.view(np.int32))
    tiles_t = torch.from_numpy(tiles)
    want = np.minimum(ref, 255).astype(np.uint8)
    for fn in (myers.myers_cross_plain, myers_cuda.myers_cross):
        got = fn(peq_t, tiles_t, W, torch.uint8)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (Q, T)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(fn(peq_t, tiles_t, W).numpy(), ref)


@pytest.mark.parametrize("W", range(1, 17))
def test_cross_geometry(W):
    """At least two carry chains a thread at every W (NQ 2 above 4
    words); the grid covers every query and tile; fewer threads only for
    fewer than 128 tiles, in whole warps."""
    for Q, T in ((1, 1), (42, 287999), (77, 301), (2048, 7552), (5, 33)):
        nq, threads, (gx, gy) = myers_cuda.cross_geometry(Q, T, W)
        assert nq >= 2 and nq == (2 if W > 4 else 4)
        assert threads % 32 == 0 and 32 <= threads <= 128
        assert threads == 128 or threads >= T
        assert gx * threads >= T > (gx - 1) * threads
        assert gy * nq >= Q > (gy - 1) * nq


def _plan_cover(nq, nt, W, sms, cap):
    """Walk the plan as `iter_ed_blocks` does (query blocks x tile
    blocks); returns the blocks' (rows, tiles). Every (row, unit) is
    covered exactly once iff the row ranges and the tile ranges each
    partition their axis."""
    rows, tiles = engine.cross_blocks(nq, nt, W, sms, cap)
    spans = []
    for n, step in ((nq, rows), (nt, tiles)):
        ends = [(a, min(a + step, n)) for a in range(0, n, step)]
        assert ends[0][0] == 0 and ends[-1][1] == n
        assert all(b == c and a < b for (a, b), (c, _) in
                   zip(ends, ends[1:] + [(n, n)]))
        spans.append([b - a for a, b in ends])
    return [(r, t) for r in spans[0] for t in spans[1]]


@pytest.mark.parametrize("sms,cap", [(132, 16 << 20), (132, 2 << 20),
                                     (1, 1 << 20), (4, 64 << 10)])
def test_cross_blocks_cover_once_under_cap(sms, cap):
    for W in (1, 2, 4, 10, 16, 46):
        for nq, nt in ((42, 287999), (42, 95977), (40000, 30943),
                       (4, 4), (20, 160), (64, 4096),
                       (2049, 511), (3, 5), (1, 1), (77, 301),
                       (4100, 129), (5000, 100000)):
            blocks = _plan_cover(nq, nt, W, sms, cap)
            assert all(r * t <= cap for r, t in blocks)
            assert all(r <= engine.QCHUNK for r, _ in blocks)
            # a block is the whole bucket, or near the cap
            rows, tiles = engine.cross_blocks(nq, nt, W, sms, cap)
            assert tiles == nt or rows * (tiles + 128) > cap // 2


def test_cross_blocks_fill_the_card():
    """At Q=42, W=1 on 132 SMs a launch has at least 1,056 CTAs where
    the bucket allows it, and the two-step path's buckets are one launch
    each under the device cap; the direct path's launches stay under its
    former 1,220."""
    sms, cap = 132, engine.CROSS_BLOCK_BYTES
    for nt in (12288, 95977, 287999, 10 ** 6):
        rows, tiles = engine.cross_blocks(42, nt, 1, sms, cap)
        nq, threads, (gx, gy) = myers_cuda.cross_geometry(rows, tiles, 1)
        assert gx * gy >= engine.CROSS_CTAS_PER_SM * sms
    assert len(_plan_cover(42, 287999, 1, sms, cap)) == 1
    assert len(_plan_cover(42, 95977, 1, sms, cap)) == 1
    assert len(_plan_cover(40000, 30943, 4, sms, cap)) <= 1220 // 10
    # a bucket smaller than that is one launch over all of it
    assert engine.cross_blocks(42, 5000, 1, sms, cap) == (42, 5000)


@pytest.mark.parametrize("bad", ["W", "dtype", "shape", "contiguity",
                                 "out_dtype", "codes"])
def test_cross_wrapper_rejects(bad):
    peq = torch.zeros((4, 16, 2), dtype=torch.int32)
    tiles = torch.zeros((5, 40), dtype=torch.uint8)
    if bad == "W":
        # W = 17 (queries over 512 bp) runs and equals burst_tpu's cross
        # scan; a table of no words is refused
        peq17, tiles17 = _inputs(717, 17, 4, 5, 600)
        np.testing.assert_array_equal(
            myers_cuda.myers_cross(torch.from_numpy(peq17.view(np.int32)),
                                   torch.from_numpy(tiles17), 17).numpy(),
            np.asarray(jmyers.myers_min_ed_cross(peq17, tiles17, 17)))
        with pytest.raises(ValueError, match="W=0"):
            myers_cuda.myers_cross(
                torch.zeros((4, 16, 0), dtype=torch.int32), tiles, 0)
    elif bad == "dtype":
        with pytest.raises(ValueError, match="int32"):
            myers_cuda.myers_cross(peq.long(), tiles, 2)
    elif bad == "shape":
        with pytest.raises(ValueError, match="2-D"):
            myers_cuda.myers_cross(peq, tiles[0], 2)
    elif bad == "codes":
        for c in (8, 32, 255):
            with pytest.raises(ValueError, match="C in"):
                myers_cuda.myers_cross(
                    torch.zeros((4, c, 2), dtype=torch.int32), tiles, 2)
    elif bad == "out_dtype":
        for dt in (torch.int64, torch.int16, torch.float32):
            with pytest.raises(ValueError, match="out_dtype"):
                myers_cuda.myers_cross(peq, tiles, 2, dt)
    else:
        with pytest.raises(ValueError, match="contiguous"):
            myers_cuda.myers_cross(peq, tiles[:, ::2], 2)


# The kernel's own source, compiled for the CPU (tests/torch_cuda_emu.py:
# a CTA's threads as std::threads at a std::barrier, the launch a loop
# over the grid), cp.async as an immediate copy (its wait and commit as
# nothing). That holds the source's index arithmetic -- staging map,
# two-stage ring, partial chunks, edge rows and queries, epilogue --
# against the plain version without a card; whether the card agrees is
# the smoke's.


class _EmulatedCross:
    """The launch entries of the emulated library: a call is
    `myers_cross_launch`, `.wide` is `myers_cross_wide_launch` (one
    thread a pair), `.group` `myers_cross_group_launch` (lane groups,
    column segments), `.thin` `myers_cross_thin_launch` (lanes across
    queries, column segments)."""

    def __init__(self, lib):
        import ctypes
        self.narrow = lib.myers_cross_launch
        self.narrow.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        self.wide = lib.myers_cross_wide_launch
        self.wide.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        self.group = lib.myers_cross_group_launch
        self.group.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        self.thin = lib.myers_cross_thin_launch
        self.thin.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 \
            + [ctypes.c_void_p]
        for f in (self.narrow, self.wide, self.group, self.thin):
            f.restype = ctypes.c_int

    def __call__(self, *args):
        return self.narrow(*args)


@pytest.fixture(scope="module")
def emulated_cross(tmp_path_factory):
    """csrc/myers_cross.cu built for the CPU: its four launch entries,
    the narrow kernels', the two wide routes' and the thin route's (their
    dynamic shared memory a static buffer, as the emulated CTAs run one
    at a time)."""
    import os

    from burst_tpu_torch.kernels import _build
    src = open(os.path.join(_build.CSRC, "myers_cross.cu")).read()
    for fn, body in (
            ("cp_async4(uint32_t* dst, const void* src,\n"
             "                                          int nbytes)",
             "{\n  uint32_t v = 0u;\n  std::memcpy(&v, src, nbytes);\n"
             "  *dst = v;\n}\n"),
            ("cp_async_commit()", "{}\n"), ("cp_async_wait_all()", "{}\n")):
        src = torch_cuda_emu.replace_function(
            src, "__device__ __forceinline__ void " + fn + " ", body)
    return _EmulatedCross(torch_cuda_emu.build(
        torch_cuda_emu.emulate(src, _build.CSRC),
        tmp_path_factory.mktemp("emu")))


@pytest.mark.parametrize("W,Q,T,Lp,offset,u8,C", [
    (1, 13, 300, 70, 0, 0, 16),      # Lp % 4: register staging
    (2, 16, 140, 100, 0, 1, 16),     # cp.async, partial last chunk
    (1, 9, 61, 96, 1, 0, 16),        # base off alignment, 64 threads
    (3, 5, 33, 131, 0, 1, 16),
    (4, 7, 200, 160, 2, 0, 16),
    (10, 5, 70, 347, 0, 1, 16),      # two chains at W=10, clipped
    (16, 3, 40, 544, 0, 0, 16),
    (1, 3, 10, 0, 0, 1, 16),         # no column at all
    (2, 9, 150, 130, 0, 1, 256),     # raw bytes, cp.async
    (4, 6, 70, 170, 1, 0, 256),      # raw bytes, register staging
    (16, 3, 20, 600, 0, 0, 256),     # the largest narrow 256-code table
    (17, 3, 150, 640, 0, 1, 16),     # the wide route: words in shared
    (46, 2, 40, 1500, 1, 0, 16),     # memory, register staging
    (20, 2, 35, 680, 0, 1, 256),     # raw bytes past 16 words
    (920, 1, 33, 40, 0, 0, 16)],     # words in a global scratch
    ids=["W1-bytes", "W2-async", "W1-off1", "W3", "W4-off2", "W10", "W16",
         "Lp0", "W2-x256", "W4-x256-off1", "W16-x256", "W17", "W46-off1",
         "W20-x256", "W920-global"])
def test_cross_kernel_source_on_cpu(emulated_cross, W, Q, T, Lp, offset,
                                    u8, C):
    peq, tiles = _inputs(600 + W + Lp, W, Q, T, max(Lp, 32 * W + 40), C)
    tiles = np.ascontiguousarray(tiles[:, :Lp])
    if W == 10:
        peq[1::2] = jmyers.build_peq(np.full((Q, 320), 5, np.uint8),
                                     np.full(Q, 317), W,
                                     score_matrix())[1::2]
    buf = np.zeros(T * Lp + offset + 4, np.uint8)
    buf[offset:offset + T * Lp] = tiles.ravel()
    out = np.zeros((Q, T), np.uint8 if u8 else np.int32)
    peq32 = np.ascontiguousarray(peq.view(np.int32))
    if W > myers_cuda.NARROW_W:
        threads, (gx, gy), smem, words = myers_cuda.cross_wide_geometry(
            Q, T, W)
        assert (words > 0) == (W == 920) and gy == Q
        scratch = np.zeros(max(1, words), np.uint32)
        assert emulated_cross.wide(
            peq32.ctypes.data, buf.ctypes.data + offset, out.ctypes.data,
            scratch.ctypes.data if words else None, Q, T, W, Lp, C,
            threads, gx, gy, smem, u8, None) == 0
    else:
        NQ, threads, (gx, gy) = myers_cuda.cross_geometry(Q, T, W)
        assert emulated_cross(peq32.ctypes.data, buf.ctypes.data + offset,
                              out.ctypes.data, Q, T, W, Lp, C, NQ, threads,
                              gx, gy, u8, None) == 0
    ref = myers.myers_cross_plain(torch.from_numpy(peq32),
                                  torch.from_numpy(tiles), W,
                                  torch.uint8 if u8 else torch.int32)
    np.testing.assert_array_equal(out, ref.numpy())
    if W == 10:
        assert ref.numpy().max() == 255 and ref.numpy().min() < 20
    if C == 256 and Lp:
        assert ref.numpy().min() <= 3


@pytest.mark.parametrize("W,NQ,threads,gx,gy", [
    (1, 8, 128, 1, 1),      # no instance carries eight queries
    (2, 2, 128, 1, 2),      # nor two at W <= 4
    (10, 4, 128, 1, 1),     # nor four above
    (4, 4, 96 + 16, 2, 1),  # not whole warps
    (4, 4, 128, 1, 1)],     # the grid misses tiles
    ids=["nq8", "nq2-W2", "nq4-W10", "threads", "grid"])
def test_cross_launch_rejects_other_geometry(emulated_cross, W, NQ, threads,
                                             gx, gy):
    """The launcher takes only the geometry `cross_geometry` gives: any
    other NQ, a CTA of part of a warp or a grid that misses tiles is
    refused before a launch, and nothing is written; so is a Peq table of
    another code count than 16 or 256."""
    Q, T, Lp = 4, 200, 64
    peq = np.zeros((Q, 256, W), np.int32)
    tiles = np.zeros((T, Lp), np.uint8)
    out = np.full((Q, T), 7, np.int32)
    assert emulated_cross(peq.ctypes.data, tiles.ctypes.data,
                          out.ctypes.data, Q, T, W, Lp, 16, NQ, threads, gx,
                          gy, 0, None) == 1
    nq, th, (x, y) = myers_cuda.cross_geometry(Q, T, W)
    assert emulated_cross(peq.ctypes.data, tiles.ctypes.data,
                          out.ctypes.data, Q, T, W, Lp, 32, nq, th, x, y, 0,
                          None) == 1
    assert (out == 7).all()


# ---------------------------------------- the lane-group wide route

def _group_case(seed, W, Q, T, Lp, codes, end=None):
    """Q queries of 32W - 20 symbols against T tiles of Lp columns with
    a pad tail; query q cut from tile q % T with two substitutions, its
    32W rows (the wildcard tail's 20 included) ending at tile column
    `end` (0-based, where given), else at a random place; the last query
    unrelated to every tile. Peq tables of 16 codes or of 256 (raw
    protein bytes)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(PROTEIN, np.uint8) if codes == 256 else \
        np.arange(1, 5, dtype=np.uint8)
    qlen = 32 * W - 20
    qs = np.zeros((Q, 32 * W), np.uint8)
    tiles = np.zeros((T, Lp), np.uint8)
    for t in range(T):
        tiles[t, :Lp - 13] = alpha[rng.integers(0, len(alpha), Lp - 13)]
    for q in range(Q):
        t = q % T
        st = end + 1 - 32 * W if end is not None else int(
            rng.integers(0, Lp - 14 - 32 * W))
        cut = tiles[t, st:st + qlen].copy()
        cut[rng.integers(0, qlen, 2)] = alpha[rng.integers(0, len(alpha),
                                                           2)]
        qs[q, :qlen] = cut if q < Q - 1 or Q == 1 else \
            alpha[rng.integers(0, len(alpha), qlen)]
    ql = np.full(Q, qlen, np.int64)
    peq = jmyers.build_peq_x(qs, ql, W) if codes == 256 else \
        jmyers.build_peq(qs, ql, W, score_matrix())
    return np.ascontiguousarray(peq.view(np.int32)), tiles


def _run_group(emulated_cross, peq32, tiles, W, u8, g, offset=0):
    """One emulated lane-group launch `g` over tiles placed `offset`
    bytes past an aligned address; returns its [Q, T] result."""
    Q, C = peq32.shape[:2]
    T, Lp = tiles.shape
    buf = np.zeros(T * Lp + offset + 4, np.uint8)
    buf[offset:offset + T * Lp] = tiles.ravel()
    out = np.zeros((Q, T), np.uint8 if u8 else np.int32)
    assert emulated_cross.group(
        peq32.ctypes.data, buf.ctypes.data + offset, out.ctypes.data, Q, T,
        W, Lp, C, g.group, g.segments, g.seg, g.over, g.pairs, g.threads,
        *g.grid, g.smem, u8, None) == 0
    return out


@pytest.mark.parametrize("W,Q,T,Lp,offset,u8,C,G,S", [
    (17, 2, 5, 700, 0, 0, 16, 8, 1),      # cp.async, 2 queries a grid.y
    (17, 2, 5, 701, 1, 1, 16, 16, 1),     # bytes through registers
    (46, 1, 3, 1500, 3, 0, 16, 32, 1),    # two words a lane
    (20, 2, 3, 680, 0, 1, 256, 8, 1),     # raw bytes, 256 codes
    (17, 2, 3, 3600, 0, 0, 16, 8, 4),     # segments, int32's overlap
    (17, 1, 3, 3001, 2, 1, 16, 16, 5),    # segments, uint8's, unaligned
    (17, 2, 2, 2500, 0, 1, 256, 32, 4),   # segments over raw bytes
    (20, 1, 2, 6000, 0, 1, 16, None, None)],  # the geometry's own plan
    ids=["G8", "G16-off1-u8", "G32-off3", "x256", "S4-int32",
         "S5-u8-off2", "S4-x256-G32", "planned"])
def test_cross_group_source_on_cpu(emulated_cross, W, Q, T, Lp, offset,
                                   u8, C, G, S):
    """K4's lane-group route, its own source compiled for the CPU, equals
    the plain version exactly at every lane-group size, with one column
    segment a pair and several, in both result types, over 16 and 256
    codes, rows of odd width at unaligned addresses, tiles past the last
    CTA's and an unrelated query. Where the columns are split, each
    query's alignment (its 32W rows) straddles the boundary of segment 2
    and, where the segments are longer than half the alignment, ends
    inside segment 3's overlap, past segment 3's first column: there the
    minimum is a column that two segments scan and only the owning one
    sees whole."""
    g = myers_cuda.cross_group_geometry(Q, T, W, Lp, C, bool(u8),
                                        group=G, segments=S)
    end = None
    if g.segments > 1:
        assert S is None or g.segments == S
        end = 3 * g.seg - g.over + 16 * W
        if S is not None:       # inside segment 3's overlap
            assert 3 * g.seg - g.over + 32 * W > end >= 3 * g.seg - g.over
            assert end < 3 * g.seg < Lp - 13
        else:                   # segments shorter than an alignment
            end = 2 * g.seg + g.seg // 2
        assert end - 32 * W + 1 < 2 * g.seg <= end < 3 * g.seg
    peq32, tiles = _group_case(W * Lp + C + (G or 0), W, Q, T, Lp, C, end)
    got = _run_group(emulated_cross, peq32, tiles, W, u8, g, offset)
    ref = myers.myers_cross_plain(torch.from_numpy(peq32),
                                  torch.from_numpy(tiles), W,
                                  torch.uint8 if u8 else torch.int32)
    np.testing.assert_array_equal(got, ref.numpy())
    assert ref.numpy().min() <= 2
    if Q > 1:
        assert ref.numpy()[-1].min() > 30      # the unrelated query
    if end is not None:
        # the best column of a planted pair is the alignment's end
        pairs = myers.myers_pairs_plain(
            torch.from_numpy(peq32), torch.from_numpy(tiles),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), W)
        assert int(pairs[0, 0]) <= 2 and \
            abs(int(pairs[2, 0]) - 1 - end) <= 2


@pytest.mark.parametrize("W", [17, 20, 33, 46, 64, 250, 460, 896, 897])
def test_cross_group_geometry(W):
    """Every lane-group launch: each pair's columns split into segments
    that each own a part (S seg >= Lp > (S - 1) seg, seg a multiple of
    4 for aligned segment starts), each scanning from an overlap of at
    least 32W + the largest minimum that matters (32W in int32, 255 in
    uint8); the lanes in flight under CROSS_FILL_WARPS warps a scheduler
    wherever segments were added; a pair's segments in one CTA of whole
    warps, at most 128 threads; the grid covering every tile and query;
    shared memory as the launcher checks it. The one-thread-a-pair
    route takes the launches whose pairs alone fill the card, and W
    past 896."""
    sms = 132
    fill = myers_cuda.CROSS_FILL_WARPS * sms * 128
    seen = set()
    for Q, T, Lp in ((4, 4, 16608), (20, 160, 1504), (64, 4096, 1504),
                     (64, 512, 1504), (1, 1, 100000), (2, 3, 0),
                     (300, 300, 3000), (1, 7, 40000)):
        for C in (16, 256):
            for u8 in (True, False):
                g = myers_cuda.cross_group_geometry(Q, T, W, Lp, C, u8, sms)
                if W > 896 or Q * T >= fill:
                    assert g is None
                    continue
                if g is None:       # the Eq table past shared memory
                    assert C == 256 and 4 * C * W > 200_000
                    continue
                G, K, S = g.group, g.words, g.segments
                assert (G, K) == myers_cuda.pair_group(W)
                assert g.over >= 32 * W + min(32 * W, 255 if u8 else
                                              32 * W)
                assert g.over % 4 == 0 and g.seg % 4 == 0
                assert S * g.seg >= Lp and (S == 1 or (S - 1) * g.seg < Lp)
                assert S == 1 or Q * T * G * S <= fill
                assert S == 1 or g.seg * 4 >= g.over - 32
                groups = g.threads // G
                assert g.threads % 32 == 0 and g.threads <= 128
                assert groups >= g.pairs * S
                gx, gy = g.grid
                assert gy == Q and gx * g.pairs >= T > (gx - 1) * g.pairs
                assert g.smem == 4 * C * K * G + 68 * groups <= 232448
                seen.add(S > 1)
    assert W > 896 or seen == {False, True}
    g = myers_cuda.cross_group_geometry(4, 4, 46, 16608)
    assert g.segments > 8 and g.seg + g.over < 16608 // 4


@pytest.mark.parametrize("bad", ["overlap", "segments", "seg4", "group",
                                 "threads", "smem", "grid"])
def test_cross_group_launch_rejects_other_geometry(emulated_cross, bad):
    """The lane-group entry takes only launches whose segments stay
    exact and cover the columns: an overlap short of 32W + 255 (uint8),
    segments that miss columns or leave one empty, a segment start off
    4-byte alignment, another lane-group size, a CTA over 128 threads or
    holding fewer groups than its tiles' segments, shared memory that
    does not match, a grid that misses tiles; each refused before a
    launch, nothing written."""
    W, Q, T, Lp = 17, 1, 3, 2400
    peq32, tiles = _group_case(3, W, Q, T, Lp, 16)
    g = myers_cuda.cross_group_geometry(Q, T, W, Lp, segments=4)
    bad_g = {"overlap": dict(over=g.over - 32),
             "segments": dict(seg=g.seg - 32),
             "seg4": dict(seg=g.seg + 2),
             "group": dict(group=4),
             "threads": dict(threads=256, smem=g.smem + 68 * (256 - g.threads)
                             // g.group),
             "smem": dict(smem=g.smem + 4),
             "grid": dict(grid=(g.grid[0] - 1, Q))}[bad]
    out = np.full((Q, T), 7, np.uint8)
    a = dict(g._asdict(), **bad_g)
    assert emulated_cross.group(
        peq32.ctypes.data, tiles.ctypes.data, out.ctypes.data, Q, T, W, Lp,
        16, a["group"], a["segments"], a["seg"], a["over"], a["pairs"],
        a["threads"], *a["grid"], a["smem"], 1, None) == 1
    assert (out == 7).all()
    assert emulated_cross.group(
        peq32.ctypes.data, tiles.ctypes.data, out.ctypes.data, Q, T, W, Lp,
        16, g.group, g.segments, g.seg, g.over, g.pairs, g.threads,
        *g.grid, g.smem, 1, None) == 0


# ---------------------------------------- the thin route (W <= 16)

def _run_thin(emulated_cross, peq32, tiles, W, u8, g, offset=0):
    """One emulated thin launch `g` over tiles placed `offset` bytes past
    an aligned address, its partial minima in a scratch where a tile's
    segments span several CTAs; returns its [Q, T] result."""
    Q, C = peq32.shape[:2]
    T, Lp = tiles.shape
    buf = np.zeros(T * Lp + offset + 4, np.uint8)
    buf[offset:offset + T * Lp] = tiles.ravel()
    out = np.zeros((Q, T), np.uint8 if u8 else np.int32)
    part = np.full(g.parts * Q * T, -1, np.int32)
    assert emulated_cross.thin(
        peq32.ctypes.data, buf.ctypes.data + offset, out.ctypes.data,
        part.ctypes.data if g.parts > 1 else None, Q, T, W, Lp, C, g.nq,
        g.segments, g.seg, g.over, g.warps, *g.grid, g.smem, u8,
        None) == 0
    return out


@pytest.mark.parametrize("W,Q,T,Lp,offset,u8,C,S", [
    (1, 130, 1, 350, 0, 1, 16, 6),       # 4 queries a lane, 2 blocks
    (5, 70, 1, 1500, 1, 1, 16, 5),       # bytes through registers
    (5, 70, 4, 1501, 0, 0, 16, 5),       # odd Lp, int32's overlap
    (10, 66, 4, 2000, 0, 1, 16, 4),
    (16, 40, 1, 4000, 2, 0, 16, 4),      # the widest, int32
    (5, 70, 2, 1500, 0, 1, 256, 5),      # raw bytes through the L1
    (2, 130, 4, 500, 3, 0, 256, 4),
    (10, 66, 1, 1200, 0, 1, 16, None)],  # the geometry's own plan
    ids=["W1-T1", "W5-off1", "W5-T4-int32", "W10-T4", "W16-off2-int32",
         "W5-x256", "W2-x256-off3", "planned"])
def test_cross_thin_source_on_cpu(emulated_cross, W, Q, T, Lp, offset, u8,
                                  C, S):
    """K4's thin route, its own source compiled for the CPU, equals the
    plain version and burst_tpu's cross scan exactly: W = 1, 2, 5, 10 and
    16, one tile and four, both result types, 16 and 256 codes (the
    tables in shared memory and through the L1 cache), rows of odd width
    at unaligned addresses, query blocks that end part way, a tile's
    segments over several CTAs (their minima merged by the second
    kernel) and in one. Each query's alignment (its 32W rows) straddles
    the boundary of segment 2 and ends inside segment 3's overlap, past
    segment 3's first column, where the segments are longer than half
    the overlap: the minimum is a column that two segments scan and only
    the owning one sees whole; elsewhere it straddles the boundary of
    segment 2."""
    g = myers_cuda.cross_thin_geometry(Q, T, W, Lp, C, bool(u8),
                                       force=True, segments=S)
    assert g.nq == (4 if W <= 4 else 2)
    end = None
    if S is not None:
        assert g.segments == S >= 4
        # inside segment 3's overlap, past its first column
        assert g.over - 16 * W <= g.seg < g.over + 16 * W - 1
        end = 3 * g.seg - g.over + 16 * W
        assert 3 * g.seg - g.over + 32 * W > end >= 3 * g.seg - g.over
    elif g.segments > 2:
        end = 2 * g.seg + min(g.seg // 2, 16 * W)
    if end is not None:
        assert end - 32 * W + 1 < 2 * g.seg <= end < 3 * g.seg
        assert end < Lp - 13
    peq32, tiles = _group_case(W * Lp + C + T, W, Q, T, Lp, C, end)
    got = _run_thin(emulated_cross, peq32, tiles, W, u8, g, offset)
    dt = torch.uint8 if u8 else torch.int32
    ref = myers.myers_cross_plain(torch.from_numpy(peq32),
                                  torch.from_numpy(tiles), W, dt).numpy()
    np.testing.assert_array_equal(got, ref)
    jref = np.asarray(jmyers.myers_min_ed_cross(peq32.view(np.uint32),
                                                tiles, W))
    np.testing.assert_array_equal(
        got, np.minimum(jref, 255).astype(np.uint8) if u8 else jref)
    # near pairs, and the unrelated query (12 symbols at W = 1)
    assert ref.min() <= 2 and ref[-1].min() > (30 if W > 1 else 2)
    if end is not None:
        # the best column of a planted pair is the alignment's end
        pairs = myers.myers_pairs_plain(
            torch.from_numpy(peq32), torch.from_numpy(tiles),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), W)
        assert int(pairs[0, 0]) <= 2 and \
            abs(int(pairs[2, 0]) - 1 - end) <= 2


def test_cross_thin_route_shapes():
    """The thin route takes the narrow launches that leave the card idle
    and gain from it: whole genomes at one tile a launch (phase 13's
    2,048 and 1,088 query rows at W = 5 against 18,848-149,280 columns)
    and the whole references' 16,569 bp bucket (316-1,250 rows at W =
    7-10 against four tiles of 16,608 columns), in both result types and
    at both code counts; never the direct cell's block (W = 4, 2,048 x
    7,680), the full-scan rows (W = 1, 42 rows against 10^5 tiles and
    more, or 2,529 of 384 bp), the ragged test shape (W = 10, 77 x 301,
    347 columns: the overlap is longer than the tile), the -x block (W =
    2, 2,048 x 1,100 at 256 codes) or a few dozen rows against a few
    hundred short tiles (W = 1, 42 x 397 at 416 columns, where the thin
    route's estimate is over half the narrow kernel's)."""
    thin = [(5, 2048, 1, 18848), (5, 2048, 1, 149280), (5, 1088, 1, 18848),
            (10, 336, 4, 16608), (7, 1250, 4, 16608), (10, 316, 4, 16608)]
    full = [(4, 2048, 7680, 480), (1, 42, 287999, 672), (1, 42, 95977, 544),
            (1, 42, 195688, 480), (1, 42, 2529, 416), (10, 77, 301, 347),
            (2, 2048, 1100, 288), (4, 2048, 397, 416), (1, 42, 397, 416),
            (1, 6, 397, 416)]
    for (W, Q, T, Lp), want in [(s, True) for s in thin] + \
            [(s, False) for s in full]:
        for C in (16, 256):
            for u8 in (True, False):
                g = myers_cuda.cross_thin_geometry(Q, T, W, Lp, C, u8, 132)
                assert (g is not None) == want, (W, Q, T, Lp, C, u8, g)
    # phase 13's longest genome: some 30 segments of the 320-column
    # overlap at W = 5, each owning some 4,700 columns, two CTAs of four
    # warps an SM (the 32 query blocks x 8 parts on 132 SMs)
    g = myers_cuda.cross_thin_geometry(2048, 1, 5, 149280)
    assert (g.segments, g.seg, g.over, g.warps, g.parts) == \
        (32, 4672, 320, 4, 8)


@pytest.mark.parametrize("W", [1, 4, 5, 7, 10, 16])
def test_cross_thin_geometry(W):
    """Every thin plan: segments that each own columns (S seg >= Lp >
    (S - 1) seg, seg a multiple of 32) and scan from an overlap of at
    least 32W + the largest minimum that matters (32W in int32, 255 in
    uint8); two segments a tile or more, none shorter than a quarter of
    its overlap; the warps in flight (a segment and query block each)
    under twice CROSS_FILL_WARPS a scheduler; at most four segments a
    CTA, a tile's segments over `parts` CTAs as even as that allows; the
    grid and shared memory as the launcher checks them. A launch whose
    pairs fill the card is never thin."""
    sms = 132
    fill = myers_cuda.CROSS_FILL_WARPS * sms * 4
    nq = 4 if W <= 4 else 2
    seen = set()
    for Q, T, Lp in ((2048, 1, 18848), (2048, 1, 149280), (1088, 1, 60000),
                     (336, 4, 16608), (3, 1, 40000), (64, 16, 5000),
                     (700, 2, 3000), (2048, 7680, 480), (42, 287999, 672)):
        for C in (16, 256):
            for u8 in (True, False):
                g = myers_cuda.cross_thin_geometry(Q, T, W, Lp, C, u8, sms)
                if -(-Q // nq) * T >= 32 * fill:
                    assert g is None
                if g is None:
                    continue
                S = g.segments
                assert g.nq == nq
                assert g.over >= 32 * W + min(32 * W, 255 if u8 else 32 * W)
                assert g.over % 32 == 0 and g.seg % 32 == 0
                assert S * g.seg >= Lp > (S - 1) * g.seg
                assert S > 1 and 4 * g.seg >= g.over - 32
                qblocks = -(-Q // (32 * nq))
                assert qblocks * T * S <= 2 * fill
                assert 1 <= g.warps <= 4
                assert g.parts * g.warps >= S > (g.parts - 1) * g.warps
                assert g.grid == (T * g.parts, qblocks)
                assert g.smem == 4 * 32 * nq * (
                    (16 * W if C == 16 else 0) + g.warps) <= 232448
                seen.add((Q, T, Lp))
    assert (2048, 1, 149280) in seen and (2048, 7680, 480) not in seen


@pytest.mark.parametrize("bad", ["overlap", "segments", "seg4", "warps",
                                 "grid", "smem", "scratch", "nq"])
def test_cross_thin_launch_rejects_other_geometry(emulated_cross, bad):
    """The thin entry takes only launches whose segments stay exact and
    cover the columns: an overlap short of 32W + 255 (uint8), segments
    that miss columns, a segment start off 4-byte alignment, over eight
    segments a CTA, a grid that misses tiles or query blocks, shared
    memory that does not match, no scratch for a tile's segments over
    several CTAs, another NQ; each refused before a launch, nothing
    written."""
    W, Q, T, Lp = 5, 70, 2, 1500
    peq32, tiles = _group_case(5, W, Q, T, Lp, 16)
    g = myers_cuda.cross_thin_geometry(Q, T, W, Lp, force=True,
                                       segments=5)
    assert g.parts > 1
    bad_g = {"overlap": dict(over=g.over - 32),
             "segments": dict(seg=g.seg - 32),
             "seg4": dict(seg=g.seg + 2),
             "warps": dict(warps=9, smem=4 * 32 * 2 * (16 * W + 9)),
             "grid": dict(grid=(g.grid[0] - 1, g.grid[1])),
             "smem": dict(smem=g.smem + 4),
             "scratch": {},
             "nq": dict(nq=4)}[bad]
    out = np.full((Q, T), 7, np.uint8)
    part = np.zeros(g.parts * Q * T, np.int32)
    a = dict(g._asdict(), **bad_g)
    args = lambda a, scratch: (
        peq32.ctypes.data, tiles.ctypes.data, out.ctypes.data, scratch, Q,
        T, W, Lp, 16, a["nq"], a["segments"], a["seg"], a["over"],
        a["warps"], *a["grid"], a["smem"], 1, None)
    assert emulated_cross.thin(*args(a, None if bad == "scratch" else
                                     part.ctypes.data)) == 1
    assert (out == 7).all()
    assert emulated_cross.thin(*args(g._asdict(), part.ctypes.data)) == 0
    ref = myers.myers_cross_plain(torch.from_numpy(peq32),
                                  torch.from_numpy(tiles), W, torch.uint8)
    np.testing.assert_array_equal(out, ref.numpy())
