"""Port parity past 512 bp: reads of 1,300-1,450 bp (W = 41-46 Myers
words) and references rescored whole, through each kernel's wide route
(on the CPU: its plain version) and through every path, against
burst_tpu on jax-CPU (its jnp routes at these shapes). The same inputs,
made from numpy seeds, go to both packages; every comparison is exact
(integers and b6 bytes): no tolerance.

  * kernel level: K1/K2 (`myers_pairs_packed`, `myers_pairs`) at W = 17,
    24 and 46, and once where a score passes the narrow kernel's 15-bit
    keys (32W + columns >= 32,768); K4 at W = 17 and 46 (16 codes) and
    W = 20 (256 codes); K3 at 600 and 1,456 DP rows, L1 = 2,048 and
    3,008, full width and windowed;
  * slice level, on 12 references of 1,450 bp (three families) sheared
    to one unit each: BEST fused with a k=12 accelerator on 1,300-1,450
    bp reads, a fifth with an N (K1 and K2); CAPITALIST with a taxonomy
    on the two-step path at QBUNCH 4; prepass (-p); the same BEST batch
    under a budget that a W = 16 plan fits (the plan regrows, and only
    once no other batch is in flight: `align_stream` with a short batch
    before the long one); and, on
    the references unsheared (the CLI's default without -s), BEST and
    ALLPATHS on 200-300 bp reads without an accelerator and the CLI's
    `-r refs.fa -q reads.fa`.

burst_tpu's CLI runs in a jax-CPU subprocess (`tests/cli_parity.py`)."""
import io
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu import prepass as jprepass
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix as jscore_matrix
from burst_tpu.io.taxonomy import Taxonomy as JTaxonomy
from burst_tpu.kernels import myers as jmyers
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.kernels.rescore import make_rescore_gather
from burst_tpu.process import process_queries as jprocess_queries
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner as JAligner
from burst_tpu_torch import engine, prepass, state
from burst_tpu_torch.alphabet import score_matrix
from burst_tpu_torch.io.taxonomy import Taxonomy
from burst_tpu_torch.kernels import myers_cuda
from burst_tpu_torch.kernels import rescore as prescore
from burst_tpu_torch.kernels import rescore_cuda
from burst_tpu_torch.process import process_queries
from burst_tpu_torch.serving import Aligner
from burst_tpu_torch.state import from_reference, load_db
from tests import cli_parity, golden

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
THRES = 0.97


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- kernel level

def _pair_inputs(seed, W, Lp, NQ, NT, B):
    """Queries of 32W-40..32W codes, every other one cut from a tile with
    a few substitutions (near pairs), tiles of random length padded with
    code 0; the pair indices put each near query on its tile."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(32 * W - 40, 32 * W + 1, NQ)
    qs = np.zeros((NQ, 32 * W), np.uint8)
    tiles = np.zeros((NT, Lp), np.uint8)
    ul = rng.integers(max(32 * W + 8, Lp - 200), Lp - 8, NT)
    for t in range(NT):
        tiles[t, :ul[t]] = rng.integers(1, 5, ul[t])
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    for q in range(NQ):
        qs[q, :qlens[q]] = rng.integers(1, 5, qlens[q])
    for i in range(0, B, 2):
        q, t = pidx[i], tidx[i]
        st = int(rng.integers(0, ul[t] - qlens[q]))
        cut = tiles[t, st:st + qlens[q]].copy()
        cut[rng.integers(0, qlens[q], 3)] = rng.integers(1, 5, 3)
        qs[q, :qlens[q]] = cut
    peq = jmyers.build_peq(qs, qlens, W, jscore_matrix())
    return peq, tiles, pidx, tidx


@pytest.mark.parametrize("W,Lp,B", [
    (17, 640, 24), (24, 900, 16), (46, 1504, 12),
    (17, 32768 - 32 * 17, 4)],
    ids=["W17", "W24", "W46", "W17-32bit-score"])
def test_pairs_plain_matches_jax_past_16_words(W, Lp, B):
    """K1 (nibble-packed) and K2 (one code per byte) on the CPU equal
    burst_tpu's `myers_min_ed_gather_pos(_packed)`; each launch would be
    the wide route on the card."""
    peq, tiles, pidx, tidx = _pair_inputs(W + Lp, W, Lp, 6, 5, B)
    ref = np.asarray(jmyers.myers_min_ed_gather_pos(
        jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
        jnp.asarray(tidx), W))
    peq_t = _t(peq.view(np.int32))
    got = myers_cuda.myers_pairs(peq_t, _t(tiles), _t(pidx), _t(tidx), W)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0].min() <= 6 and ref[0].max() > 100
    if Lp < 30000:    # the packed format too (32,224 columns: K2 alone)
        packed = jmyers.pack_nibbles_np(tiles)
        ref_p = np.asarray(jmyers.myers_min_ed_gather_pos_packed(
            jnp.asarray(peq), jnp.asarray(packed), jnp.asarray(pidx),
            jnp.asarray(tidx), W))
        got_p = myers_cuda.myers_pairs_packed(peq_t, _t(packed), _t(pidx),
                                              _t(tidx), W)
        np.testing.assert_array_equal(got_p.numpy(), ref_p)
    assert myers_cuda.pair_wide(W, Lp)
    assert (32 * W + Lp >= myers_cuda.KEY_LIMIT) == (Lp > 30000)


@pytest.mark.parametrize("W,C,Q,T,Lp", [
    (17, 16, 5, 7, 640), (46, 16, 3, 4, 1504), (20, 256, 4, 5, 700)],
    ids=["W17", "W46", "W20-x256"])
def test_cross_plain_matches_jax_past_16_words(W, C, Q, T, Lp):
    """K4 on the CPU equals burst_tpu's `myers_min_ed_cross`, int32 and
    clipped to uint8; the card's route for these is the wide one (one
    query a CTA)."""
    rng = np.random.default_rng(W + C)
    qlen = 32 * W - 20
    alpha = PROTEIN if C == 256 else np.arange(1, 5, dtype=np.uint8)
    qs = np.zeros((Q, 32 * W), np.uint8)
    tiles = np.zeros((T, Lp), np.uint8)
    for t in range(T):
        tiles[t, :Lp - 30] = alpha[rng.integers(0, len(alpha), Lp - 30)]
    for q in range(Q):
        t = q % T
        st = int(rng.integers(0, Lp - 30 - qlen))
        cut = tiles[t, st:st + qlen].copy()
        cut[rng.integers(0, qlen, 2 + q)] = alpha[0]
        qs[q, :qlen] = cut
    ql = np.full(Q, qlen, np.int64)
    peq = jmyers.build_peq_x(qs, ql, W) if C == 256 else \
        jmyers.build_peq(qs, ql, W, jscore_matrix())
    ref = np.asarray(jmyers.myers_min_ed_cross(peq, tiles, W))
    got = myers_cuda.myers_cross(_t(peq.view(np.int32)), _t(tiles), W)
    np.testing.assert_array_equal(got.numpy(), ref)
    got8 = myers_cuda.myers_cross(_t(peq.view(np.int32)), _t(tiles), W,
                                  torch.uint8)
    np.testing.assert_array_equal(got8.numpy(), np.minimum(ref, 255))
    assert ref.min() <= 6 and ref.max() > 255
    assert myers_cuda.cross_geometry(Q, T, W)[0] == 1


def _rescore_case(seed, W, qlen, P, lt, budget):
    """P queries of about qlen codes cut from their own tile with
    substitutions and indels within `budget`, tiles of up to lt - 32W
    codes padded to lt columns (the engine's rescore pad)."""
    rng = np.random.default_rng(seed)
    ulen = lt - 32 * W
    tiles = np.zeros((P, lt), np.uint8)
    qs = np.zeros((P, 32 * W), np.uint8)
    qlens = np.zeros(P, np.int64)
    for i in range(P):
        n = int(rng.integers(max(qlen + 8, ulen - 60), ulen + 1))
        tiles[i, :n] = rng.integers(1, 5, n)
        st = int(rng.integers(0, n - qlen))
        q = tiles[i, st:st + qlen].copy()
        for _ in range(int(rng.integers(0, budget // 2))):
            p = int(rng.integers(0, len(q)))
            op = int(rng.integers(0, 3))
            if op == 0:
                q[p] = rng.integers(1, 5)
            elif op == 1:
                q = np.delete(q, p)
            else:
                q = np.insert(q, p, rng.integers(1, 5))[:32 * W]
        qlens[i] = len(q)
        qs[i, :len(q)] = q
    peq = jmyers.build_peq(qs, qlens, W, jscore_matrix())
    max_ed = np.full(P, budget, np.int64)
    return peq, tiles, qlens, max_ed


@pytest.mark.parametrize("W,qlen,L1,windowed", [
    (19, 600, 2048, False), (19, 600, 2048, True),
    (46, 1450, 3008, False), (46, 1450, 3008, True)],
    ids=["rows600-full", "rows600-window", "rows1456-full",
         "rows1456-window"])
def test_rescore_plain_matches_jax_past_511_rows(W, qlen, L1, windowed):
    """K3 on the CPU (through `rescore_cuda`, as the engine calls it)
    equals burst_tpu's jnp rescore (`make_rescore_gather`: its wide int32
    planes at these shapes): at 600 and 1,456 DP rows, full width at
    L1 = 2,048 and 3,008 and windowed; the card's route keeps the row in
    registers (one warp a pair in the 640-column window of 600 rows)."""
    budget = int(qlen * (1 - THRES))
    peq, tiles, qlens, max_ed = _rescore_case(W + L1, W, qlen, 4, L1 - 1,
                                              budget)
    P = len(qlens)
    idx = np.arange(P, dtype=np.int32)
    rows = prescore.rows_for(qlens, W)
    levels = prescore.levels_for(max_ed)
    fn, fn_win = make_rescore_gather(jscore_matrix())
    if windowed:
        # x0 as engine.rescore_winners takes it: the pair scan's first
        # best column less the rows and the budget
        first = myers_cuda.myers_pairs(
            _t(peq.view(np.int32)), _t(tiles), _t(idx), _t(idx), W)[1]
        x0 = np.maximum(first.numpy() - 32 * W - max_ed - 1, 0)
        Lw = -(-(rows + budget + 2) // 128) * 128
        ref = np.asarray(fn_win(
            jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(idx),
            jnp.asarray(idx), jnp.asarray(qlens.astype(np.int32)),
            jnp.asarray(max_ed.astype(np.int32)),
            jnp.asarray(x0.astype(np.int32)), W, Lw, levels, rows))
        got = rescore_cuda.rescore_pairs_gather(
            _t(peq.view(np.int32)), _t(tiles), idx, idx, qlens, max_ed, W,
            x0=x0, Lw=Lw)
        assert rescore_cuda.rescore_geometry(P, rows, Lw, 16 * W)[0] == \
            ("warp" if Lw <= 1024 else "wide")
    else:
        ref = np.asarray(fn(
            jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(idx),
            jnp.asarray(idx), jnp.asarray(qlens.astype(np.int32)),
            jnp.asarray(max_ed.astype(np.int32)), W, levels, rows))
        qmeta = np.stack([qlens, max_ed], 1).astype(np.int32)
        got = rescore_cuda.rescore(
            _t(peq.reshape(P, 16 * W).view(np.int32)), _t(tiles),
            _t(qmeta), W, levels, rows, L1)
        assert rescore_cuda.rescore_geometry(P, rows, L1, 16 * W)[0] == \
            "wide"
    np.testing.assert_array_equal(got.numpy(), ref)
    assert rows > 511 and (ref[0] <= max_ed).sum() >= P // 2


def test_rescore_geometry_routes():
    """Up to 1,024 columns (the shapes of the first design's block
    route, up to 511 rows, and past 511 rows) the warp route: one warp a
    pair, L1 / 32 columns a lane where the look-back window fits a
    lane's run, else a power of two, four pairs a CTA (fewer where their
    Peq tables pass 48 KB), a 64-bit key where the fields pass 31 bits
    (L1 = 1,024 at levels 10); past 1,024 columns the wide route, the
    row in the registers of one CTA a pair (8, 16 or 32 columns a
    thread, halo lanes at least a look-back window wide): a 16,569 bp
    reference rescored whole (L1 = 17,024) in 18 warps of 32 columns a
    thread; past what one CTA's registers hold the segment route (a
    contig of 262 kbp, a row of 5 Mbp: overlapping windows on the wide
    route, pairs x segments CTAs); where a window would be mostly
    margin (1,456 rows at a look-back of 64 or 16) the cluster route, at
    any width: a cluster of CTAs a pair, past its reach windows of that
    reach, one cluster each (tests/test_torch_cluster.py holds its
    launches)."""
    g = rescore_cuda.rescore_geometry
    smem = rescore_cuda.rescore_wide_smem
    assert g(100, 296, 1024, 160) == \
        ("warp", 128, 25, smem(1, 0, 32, 160, 4), 32, 0, 4)
    assert g(8192, 296, 384, 160, levels=3) == \
        ("warp", 128, 2048, smem(1, 0, 12, 160, 4), 12, 0, 4)
    assert g(8192, 296, 384, 160, levels=4)[4] == 16     # window 16 > 12
    assert g(4096, 104, 128, 64, levels=2)[4] == 4
    assert g(4096, 104, 640, 64, levels=2)[4] == 20
    assert g(3, 500, 1024, 256, levels=10)[:5] == ("warp", 96, 1,
                                                    smem(1, 0, 32, 256, 3),
                                                    32)
    assert g(100, 512, 640, 16 * 17)[0] == "warp"
    assert g(100, 1456, 3072, 16 * 46, levels=6)[:2] == ("wide", 224)
    assert g(100, 1456, 1536, 16 * 46, levels=6) == \
        ("wide", 256, 100, smem(8, 8, 8, 736), 8, 8, 1)
    wide = g(100, 304, 17024, 160, sms=132, levels=4)
    assert wide[:3] == ("wide", 576, 100) and wide.cols == 32 and \
        wide.halo == 1
    assert g(1000, 304, 17024, 160, sms=132, levels=4).grid == 1000
    sg = rescore_cuda.rescore_segments(1000, 304, 262144, 160, sms=132)
    assert sg == (4096, 3487, 608, 76)
    assert g(1000, 304, 262144, 160, sms=132) == \
        ("segments", 544, 1000 * 76, smem(17, 1, 8, 160), 8, 1, 1)
    big = g(1000, 304, 5_000_064, 160, sms=132)
    assert big[:4] == ("segments", 544, 1000 * 1434, smem(17, 1, 8, 160))
    clu = g(1000, 1456, 262144, 16 * 46, sms=132, levels=6)
    reach = rescore_cuda.cluster_reach(16 * 46, 6, rows=1456)
    assert (clu.route, clu.cluster, clu.segs, clu.window) == \
        ("cluster", 16, 3, reach)
    clu = g(1000, 1456, 5_000_064, 16 * 46, sms=132, levels=4)
    assert clu.route == "cluster" and clu.segs > 1 and \
        clu.grid == 1000 * clu.segs * clu.cluster
    assert g(10, 296, 1024, 256 * 32, levels=4) == \
        ("warp", 32, 10, smem(1, 0, 32, 8192), 32, 0, 1)  # 32 KB of Peq


def test_rescore_wide_geometry_covers_every_launch():
    """Every register-route launch: the warps' own columns cover L1 and
    one warp fewer would not, a warp's halo holds a look-back window, a
    run of columns that is no power of two only in one warp holding the
    window, the key's fields within its 32 or 64 bits, several pairs a
    CTA only one warp each and the grid covering every pair, threads
    within the instance's launch bound and shared memory within what a
    CTA may opt into; the planned state (C keys and shiftR) within a
    thread's 255 registers; on the segment route the same of its
    window's launch over pairs x segments. Every instance is planned
    somewhere, and every shape up to 1,024 columns takes the warp
    route."""
    g = rescore_cuda.rescore_geometry
    seen, segs = set(), 0
    for L1 in [128 * k for k in range(1, 160)] + [17024, 32768, 65536]:
        for levels in range(1, 11):
            for pequ32 in (16 * 46, 256 * 20):
                r = g(64, 1456, L1, pequ32, levels=levels)
                sg = rescore_cuda.rescore_segments(64, 1456, L1, pequ32,
                                                   levels=levels)
                if r.route in ("global", "cluster", "bands"):
                    assert L1 > 1024 and sg is None
                    continue
                L, N = L1, 64     # the row, or the segments' window
                if r.route == "segments":
                    assert sg.window < L1 and rescore_cuda.register_geometry(
                        N, L1, pequ32, levels) is None
                    L, N = sg.window, N * sg.segs
                    segs += 1
                sb, gb, db, w = rescore_cuda.rescore_key_bits(L, levels)
                kb = 32 if sb + gb + db <= 31 else 64
                assert sb + gb + db <= 63 and (kb == 32 or r.cols == 32)
                C, H, P = r.cols, r.halo, r.pairs
                nw = r.threads // 32 // P
                assert (r.route == "warp") <= (nw == 1) == (L <= 1024)
                own = 32 * C if nw == 1 else (32 - H) * C
                assert nw * own >= L > (nw - 1) * own
                assert (H == 0) == (nw == 1) and (nw == 1 or H * C >= w)
                assert C & (C - 1) == 0 or (nw == 1 and w <= C)
                assert P == 1 or nw == 1
                assert r.grid * P >= N > (r.grid - 1) * P
                assert H <= rescore_cuda.WIDE_MAX_HALO
                assert r.threads <= (32 * rescore_cuda.WARP_PAIRS
                                     if nw == 1 else
                                     rescore_cuda.WIDE_MAX_THREADS[C])
                assert r.smem == rescore_cuda.rescore_wide_smem(
                    nw, H, C, pequ32, P) <= rescore_cuda.SMEM_MAX
                assert (kb // 32 + 1) * C <= 255
                seen.add((C, nw > 1, kb))
    assert segs > 0
    assert seen == {(C, False, 32) for C in range(4, 33, 4)} | \
        {(C, True, 32) for C in (8, 16, 32)} | {(32, False, 64)}


# -------------------------------------------------------- slice level

def _families(rng, n_fam, n_mem, length, div=0.015):
    refs, heads = [], []
    for f in range(n_fam):
        anc = rng.choice(BASES, size=length)
        for m in range(n_mem):
            r = anc.copy()
            pos = rng.integers(0, length, int(length * div))
            r[pos] = BASES[rng.integers(0, 4, len(pos))]
            refs.append(r)
            heads.append(b"f%02dm%02d" % (f, m))
    return heads, refs


def _long_reads(rng, refs, n, lo, hi, n_every=5):
    """n reads of lo..hi bp from the references with 0.5 % substitutions,
    a third reverse complemented, every n_every-th with an N."""
    reads, heads = [], []
    for i in range(n):
        s = refs[int(rng.integers(0, len(refs)))]
        ln = int(rng.integers(lo, min(hi, len(s)) + 1))
        st = int(rng.integers(0, len(s) - ln + 1))
        r = s[st:st + ln].copy()
        pos = rng.integers(0, ln, ln // 200)
        r[pos] = BASES[rng.integers(0, 4, len(pos))]
        if i % 3 == 1:
            r = np.frombuffer(r[::-1].tobytes().translate(COMP),
                              np.uint8).copy()
        if n_every and i % n_every == 2:
            r[int(rng.integers(0, ln))] = ord("N")
        reads.append(r)
        heads.append(b"r%03d" % i)
    return heads, reads


@pytest.fixture(scope="module")
def long_work():
    """12 references of 1,450 bp (three families of four at 1.5 % from
    their ancestor), sheared to one unit each (max_len_q 1,500 at -i
    0.97: a 1,546 bp shear), a k=12 accelerator; 24 reads of 1,300-1,450
    bp, a fifth with an N; a taxonomy over the references."""
    rng = np.random.default_rng(1450)
    rheads, refs = _families(rng, 3, 4, 1450)
    heads, reads = _long_reads(rng, refs, 24, 1300, 1450)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=1500, thres=THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    jengine.rd_acc_unit_index(rd, acc)
    prd, pacc = from_reference(rd, acc)
    tax = [(h, b"k__K;p__P;c__C%d;o__O%d;f__F%d;g__G%d;s__S%s" % (
        int(h[1:3]), int(h[1:3]), int(h[4:6]) % 2, int(h[4:6]) % 2, h))
        for h in rheads]
    return dict(rd=rd, acc=acc, prd=prd, pacc=pacc, heads=heads,
                reads=reads, rheads=rheads, refs=refs,
                jtax=JTaxonomy(tax), ptax=Taxonomy(tax))


@pytest.fixture
def one_budget(monkeypatch):
    """One slot budget and chunk in both packages (a row that overflows
    its budget is scanned at its own W, one that does not at the batch's
    widest), the fused path on in burst_tpu."""
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "4096")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)


def _jax_bytes(w, mode, n=None, **kw):
    return JAligner(w["rd"], w["acc"], thres=THRES, mode=mode, do_rc=True,
                    **kw).align_batch(w["heads"][:n],
                                      [r.copy() for r in w["reads"][:n]])


def test_long_fused_best_matches_jax(long_work, one_budget):
    """BEST with the accelerator at QBUNCH 1: the fused scan (K1 over
    the clear rows at W = 46) and the side pairs of the N rows (K2,
    bucketed by W = 41..46), rescored at up to 1,456 rows."""
    w = long_work
    ref = _jax_bytes(w, "BEST")
    al = Aligner(w["prd"], w["pacc"], thres=THRES, mode="BEST", do_rc=True,
                 device="cpu")
    got = al.align_batch(w["heads"], [r.copy() for r in w["reads"]])
    assert got == ref and ref.count(b"\n") >= 10
    st = al.last_stats
    assert st["qbunch"] == 1 and st["dev_pairs"] > 0 and \
        st["side_pairs"] > 0


def test_long_twostep_capitalist_matches_jax(long_work, one_budget,
                                             monkeypatch):
    """CAPITALIST with the 7-level taxonomy on the two-step path at
    QBUNCH 4 (both packages' QBUNCH forced: the batch's own is 1), on the
    first 12 reads: K2 at each read's W, K3 at up to 1,456 rows."""
    w = long_work
    jcand = jengine.accel_candidates

    def at4(*a, **kw):
        if kw.get("qbunch") is None:
            kw["qbunch"] = 4
        return jcand(*a, **kw)
    monkeypatch.setattr(jengine, "accel_candidates", at4)
    monkeypatch.setattr(engine, "default_qbunch", lambda n, t: 4)
    ref = _jax_bytes(w, "CAPITALIST", 12, taxonomy=w["jtax"])
    al = Aligner(w["prd"], w["pacc"], thres=THRES, mode="CAPITALIST",
                 do_rc=True, device="cpu", taxonomy=w["ptax"])
    got = al.align_batch(w["heads"][:12],
                         [r.copy() for r in w["reads"][:12]])
    assert got == ref and ref.count(b"\n") >= 10
    assert al.last_stats["qbunch"] == 4 and al.last_stats["pairs"] > 0


def test_long_prepass_matches_jax(long_work):
    """Prepass (-p, BEST, ITER 16) on the long reads: K2 at W = 41..46."""
    w = long_work
    a = dict(mode="BEST", prepass=16, rc=True, heur=False)
    jqd = jprocess_queries(w["heads"], [r.copy() for r in w["reads"]],
                           THRES, False)
    ref = io.StringIO()
    assert jprepass.run_prepass(jqd, w["rd"], w["acc"],
                                dict(a, smat=jscore_matrix()), ref,
                                None) == 101
    pqd = process_queries(w["heads"], [r.copy() for r in w["reads"]],
                          THRES, False)
    got = io.StringIO()
    db = load_db(w["prd"], w["pacc"], score_matrix(), "cpu")
    assert prepass.run_prepass(pqd, db, w["pacc"], a, got, None) == 101
    assert got.getvalue() == ref.getvalue()
    assert ref.getvalue().count("\n") >= 20


def test_long_batch_regrows_the_plan(long_work, monkeypatch):
    """A budget that a plan for reads of up to 16 words fits, and just
    holds two slabs of 8 rows of this batch's widest rescore rows: the
    long batch regrows the plan before its first copy (reported in
    `last_stats`), streams its rescore rows through the grown ring, and
    gives burst_tpu's bytes (its two-step path at QBUNCH 1: the budget
    holds no packed store, so there is no fused scan); a budget under
    those two slabs raises ValueError."""
    w = long_work
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "0")
    prd = w["prd"]
    w46 = state.widest_row(prd, 46)
    budget = _w16_budget(prd)
    assert w46 > state.widest_row(prd, state.PLAN_W)
    ref = _jax_bytes(w, "BEST")
    al = Aligner(prd, w["pacc"], thres=THRES, mode="BEST", do_rc=True,
                 device="cpu", tile_budget=budget)
    assert al.db.plan.min_slot < state.SLAB_MIN_ROWS * w46
    got = al.align_batch(w["heads"], [r.copy() for r in w["reads"]])
    assert got == ref and ref.count(b"\n") >= 10
    st = al.last_stats
    assert st["regrow"] == {"words": 46, "slot": al.db.plan.slot}
    assert al.db.plan.slot >= state.SLAB_MIN_ROWS * w46
    assert st["pieces"] > 0 and st["scour"] == "native"
    al.align_batch(w["heads"][:2], [r.copy() for r in w["reads"][:2]])
    assert "regrow" not in al.last_stats
    small = Aligner(prd, w["pacc"], thres=THRES, mode="BEST", device="cpu",
                    tile_budget=budget - 1024)
    i = int(np.argmax([len(r) for r in w["reads"]]))
    assert len(w["reads"][i]) > 32 * 45
    for _ in range(2):    # and again: the plan stays what it was
        with pytest.raises(ValueError, match="cannot hold"):
            small.align_batch(w["heads"][i:i + 1], [w["reads"][i].copy()])
        assert small.db.plan_w == state.PLAN_W


def _w16_budget(prd):
    """A budget that a plan for reads of up to 16 words fits, and that
    just holds two slabs of 8 rows of 46-word reads' rescore rows."""
    return score_matrix().nbytes + 2 * state.SLAB_MIN_ROWS * \
        state.widest_row(prd, 46)


def test_regrowth_waits_for_batches_in_flight(long_work):
    """A batch of longer reads regrows the plan only once no other batch
    is in flight: while one holds the plan, the regrowth waits (the plan
    unchanged), and it runs as soon as that batch ends."""
    prd = long_work["prd"]
    db = load_db(prd, long_work["pacc"], score_matrix(), "cpu",
                 tile_budget=_w16_budget(prd))
    room = db.plan.min_slot
    grown = threading.Thread(target=db.fit_words, args=(46,))
    with db.batch(10) as grew:
        assert not grew
        grown.start()
        grown.join(0.5)
        assert grown.is_alive()
        assert db.plan_w == state.PLAN_W and db.plan.min_slot == room
    grown.join(60)
    assert not grown.is_alive()
    assert db.plan_w == 46 and db.plan.min_slot == \
        state.SLAB_MIN_ROWS * state.widest_row(prd, 46) > room
    with db.batch(46) as grew:      # room made already
        assert not grew


def test_stream_short_then_long_batch(long_work):
    """`align_stream` with two batches in flight under that budget: a
    batch of 300 bp cuts, then the long reads (which regrow the plan
    while the first may still run), then the cuts again; each batch's
    bytes equal its own `align_batch` on a fresh aligner."""
    w = long_work
    prd, budget = w["prd"], _w16_budget(w["prd"])
    short = ([b"s" + h for h in w["heads"][:8]],
             [r[:300].copy() for r in w["reads"][:8]])
    long_ = (w["heads"][:8], [r.copy() for r in w["reads"][:8]])
    batches = [short, long_, short]

    def aligner():
        return Aligner(prd, w["pacc"], thres=THRES, mode="BEST", do_rc=True,
                       device="cpu", tile_budget=budget)
    ref = [aligner().align_batch(*b) for b in batches]
    got = list(aligner().align_stream(iter(batches), depth=2))
    assert got == ref
    assert all(r.count(b"\n") >= 4 for r in ref)


@pytest.fixture(scope="module")
def whole_refs():
    """The same families' 12 references unsheared (one unit each, as
    `-r refs.fa` without -s builds them) and 60 reads of 200-300 bp."""
    rng = np.random.default_rng(300)
    rheads, refs = _families(rng, 3, 4, 1450)
    heads, reads = _long_reads(rng, refs, 60, 200, 300, n_every=0)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=300, thres=THRES, rebase=False,
                            rebase_amt=320, curate=2)
    prd, _ = from_reference(rd)
    return dict(rd=rd, prd=prd, heads=heads, reads=reads, rheads=rheads,
                refs=refs)


@pytest.mark.parametrize("mode", ["BEST", "ALLPATHS"])
def test_whole_references_direct_matches_jax(whole_refs, mode):
    """No accelerator: every read against every whole 1,450 bp unit
    (K4), the winners rescored at full width, L1 = 1,920 (K3's wide
    route on the card)."""
    w = whole_refs
    ref = JAligner(w["rd"], None, thres=THRES, mode=mode, do_rc=True
                   ).align_batch(w["heads"], [r.copy() for r in w["reads"]])
    got = Aligner(w["prd"], None, thres=THRES, mode=mode, do_rc=True,
                  device="cpu").align_batch(w["heads"],
                                            [r.copy() for r in w["reads"]])
    assert got == ref and ref.count(b"\n") >= 60
    lb = int(engine._unit_lb(w["prd"]).max())
    assert prescore.l1_for(lb + engine.rescore_pad(lb, 10)) > 1024


def test_whole_references_cli_matches_jax(whole_refs, tmp_path):
    """`-r refs.fa -q reads.fa` without -s (the references unsheared)
    through both command lines: the same b6 bytes."""
    w = whole_refs
    golden.write_fasta(str(tmp_path / "refs.fa"), [
        (h.decode(), r.tobytes().decode())
        for h, r in zip(w["rheads"], w["refs"])])
    golden.write_fasta(str(tmp_path / "reads.fa"), [
        (h.decode(), r.tobytes().decode())
        for h, r in zip(w["heads"], w["reads"])])
    cases = {"best": ["-r", str(tmp_path / "refs.fa"), "-q",
                      str(tmp_path / "reads.fa"), "-o", "{o}/b.b6", "-m",
                      "BEST", "-fr"]}
    assert cli_parity.reference(tmp_path, cases) == {"best": 0}
    assert cli_parity.ours(tmp_path, cases["best"]) == 0
    cli_parity.assert_same_files(tmp_path, ["b.b6"], min_lines=60)
