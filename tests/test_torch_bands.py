"""K3's band route: a pair's DP rows in bands, each band one launch of
the cluster kernel over overlapping column windows whose margin is the
band's dependency cone, each band's last row stored once a pair in
device memory for the next band (`rescore_band_launch`), the last
band's partial results joined by the merge kernel. csrc/rescore.cu
itself compiled for the CPU (tests/torch_cuda_emu.py: a cluster's CTAs
run together, each with its own shared buffer), driven by the wrapper's
own band loop (`rescore_cuda._band_run`, its entries swapped for the
emulated ones) on the launches `rescore_bands` plans with a card's
reach forced small (`kmax`, `sms`, a window cap `wmax`), against the
plain version `rescore_plain` over the whole row: exact equality
(integer DP), every pair, out-of-budget and dead ones included. Then
the planner over the shapes a path can reach (no global route), the
entry refusing launches it did not plan, and the direct path's bytes
against burst_tpu with reads past 1,472 bp. Inputs from numpy seeds;
Peq tables from burst_tpu's Peq functions (`tests/test_torch_segments`)."""
import ctypes
import os
import types

import numpy as np
import pytest
import torch

from burst_tpu_torch import engine
from burst_tpu_torch.kernels import _build, rescore_cuda
from burst_tpu_torch.kernels import rescore as prescore
from tests import cli_parity
from tests.test_torch_segments import _seg_case

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """csrc/rescore.cu built for the CPU: its band and merge entries."""
    from tests import torch_cuda_emu
    src = open(os.path.join(_build.CSRC, "rescore.cu")).read()
    lib = torch_cuda_emu.build(torch_cuda_emu.emulate(src),
                               tmp_path_factory.mktemp("emu_bands"))
    return (torch_cuda_emu.entry(lib, "rescore_band_launch",
                                 [_P] * 7 + [_I] * 19 + [_P]),
            torch_cuda_emu.entry(lib, "rescore_merge_launch",
                                 [_P] * 3 + [_I] * 3 + [_P]))


def _bands_run(emu, monkeypatch, g, peq, tiles, qmeta, W, levels, rows,
               L1, tidx=None):
    """`rescore_cuda._band_run` on CPU tensors with the emulated band
    and merge entries in place of the card's: its [4, N], and the band
    launches it made."""
    band, merge = emu
    monkeypatch.setattr(rescore_cuda._build, "load", lambda name, sig:
                        types.SimpleNamespace(rescore_band_launch=band))
    monkeypatch.setattr(rescore_cuda._build, "launch",
                        lambda dev, entry, *a, what=None:
                        _build.check(entry(*a), what))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev:
                        types.SimpleNamespace(cuda_stream=None))

    def merged(part, qm, rows_):
        out = np.full((4, qm.shape[0]), -7, np.int32)
        assert merge(part.data_ptr(), qm.data_ptr(), out.ctypes.data,
                     qm.shape[0], part.shape[1] // qm.shape[0], rows_,
                     None) == 0
        return torch.from_numpy(out)
    monkeypatch.setattr(rescore_cuda, "rescore_merge", merged)
    n0 = rescore_cuda.rescore.routes["bands"]
    out = rescore_cuda._band_run(
        _t(peq), _t(tiles), _t(qmeta), W, levels, rows, L1,
        None if tidx is None else _t(tidx), g).numpy()
    return out, rescore_cuda.rescore.routes["bands"] - n0


def _in_bands(g, R, L1, levels):
    """The band plan `g` with bands of R rows: the band's margin, the
    windows' own columns and their count."""
    M = rescore_cuda.segment_margin(R + 1, levels)
    own = g.window - 1 - M
    assert own >= 32
    return g._replace(band=R, margin=M, own=own, segs=-(-(L1 - 1) // own))


# (W, qlen, L1, levels, codes, window cap, CTAs a cluster at most, rows
# a band (0: the plan's), key bits, kinds): `_seg_case`'s kinds, their
# column boundary the first window's last owned column; out-of-budget
# pairs and pairs under a budget of 0 (dead cells all along)
@pytest.mark.parametrize("W,qlen,L1,levels,codes,wmax,kmax,R,kb,kinds", [
    (1, 20, 1024, 1, 16, 256, 2, 5, 32, ("gap", "tie", "far", "zero")),
    (2, 36, 1536, 3, 256, 512, 2, 6, 32, ("gap", "tie", "hit")),
    (2, 36, 2048, 5, 16, 768, 3, 6, 32, ("gap", "far")),
    (1, 20, 3072, 8, 16, 2048, 2, 5, 32, ("tie", "zero")),
    (1, 20, 4096, 9, 256, 3072, 2, 2, 64, ("tie", "zero"))],
    ids=["lv1", "lv3-x256", "lv5-K3", "lv8", "key64-lv9-x256"])
def test_band_kernel_source_on_cpu(emu, monkeypatch, W, qlen, L1, levels,
                                   codes, wmax, kmax, R, kb, kinds):
    """The band route, its kernel's own source compiled for the CPU and
    driven band by band by the wrapper's loop, equals `rescore_plain`
    exactly: look-backs of 2 to 256 columns, 16 and 256 codes, 32- and
    64-bit keys (gap_q's field sized by the whole row, not the window:
    past 31 bits at 4,096 columns and a look-back of 512), two bands or
    more with rows no multiple of the band's (a last band shorter than
    the others), windows of a small cluster's reach; a
    left-gap chain and the copies of a tie across the first window
    boundary, pairs out of budget and under a budget of 0 agree too."""
    rows = prescore.rows_for(np.array([qlen]), W)
    g = rescore_cuda.rescore_bands(len(kinds), rows, L1, codes * W, sms=2,
                                   levels=levels, kmax=kmax, wmax=wmax)
    if R:
        g = _in_bands(g, R, L1, levels)
    nb = -(-rows // g.band)
    assert g.route == "bands" and nb >= 2 and g.segs >= 2
    assert rows % g.band or kb == 64
    assert g.kb == kb and g.window <= wmax and g.cluster <= kmax
    assert g.margin >= 1 + g.band * (1 << levels)
    peq, tiles, qmeta, rows = _seg_case(W * L1 + levels + codes, W, qlen,
                                        L1, codes, levels, kinds, g.own)
    out, launches = _bands_run(emu, monkeypatch, g, peq, tiles, qmeta, W,
                               levels, rows, L1)
    ref = prescore.rescore_plain(_t(peq), _t(tiles), _t(qmeta), W, levels,
                                 rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert launches == nb
    for i, kind in enumerate(kinds):
        if kind in ("far", "zero"):
            assert ref[0, i] > qmeta[i, 1]
        elif kind == "hit":
            assert ref[0, i] == 0
        elif kind == "tie":
            assert ref[0, i] == 0 and ref[3, i] + (rows - qlen) > g.own


def test_band_chunks_and_bucket_rows_on_cpu(emu, monkeypatch):
    """Bucket rows read by tile index (repeated and out of order, columns
    past Lt code 0, a longer row stride) and the pairs in chunks of 2 (as
    where their stored rows would pass BAND_ROW_BYTES: each chunk its own
    two rows and its own merge), a look-back of 16 over rows 24 in bands
    of 8 (three bands, the rows a multiple of them): exact against
    `rescore_plain` on the gathered tiles."""
    W, qlen, L1, levels = 1, 24, 1024, 4
    rows = prescore.rows_for(np.array([qlen]), W)
    g = rescore_cuda.rescore_bands(4, rows, L1, 16 * W, sms=2,
                                   levels=levels, kmax=2, wmax=512)
    g = _in_bands(g, 8, L1, levels)._replace(chunk=2)
    peq, tiles, qmeta, rows = _seg_case(17, W, qlen, L1, 16, levels,
                                        ("gap", "tie", "zero"), g.own)
    Lt = L1 - 1 - 100
    bucket = np.zeros((3, Lt + 64), np.uint8)
    bucket[:, :Lt] = tiles[:, :Lt]
    bucket[:, Lt:] = 3                      # past Lt: never read
    tidx = np.array([2, 0, 2, 1], np.int64)
    peq, qmeta = peq[tidx].copy(), qmeta[tidx].copy()
    gathered = np.zeros((4, L1 - 1), np.uint8)
    gathered[:, :Lt] = bucket[tidx, :Lt]
    out, launches = _bands_run(emu, monkeypatch, g, peq, bucket, qmeta, W,
                               levels, rows, L1, tidx)
    ref = prescore.rescore_plain(_t(peq), _t(gathered), _t(qmeta), W,
                                 levels, rows, L1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert launches == 2 * 3          # two chunks of three bands


def test_band_launch_rejects_other_geometry(emu):
    """The band entry takes only what `rescore_bands` plans: a margin
    short of the band's cone (band 0: 1 + (y1 - 1) 2^levels; later
    bands 1 + (y1 - y0) 2^levels), windows that miss a column, rows past
    the last or none, a stored row missing where a band starts past row
    0 or given where it starts at 0, an output row missing before the
    last band, partial results before the last band or missing at it,
    rows of 2^16 (the stored shiftR's bits), another halo or cluster
    size; nothing is written. The plans themselves run."""
    band, _ = emu
    N, W, L1, levels, rows = 2, 1, 1024, 2, 24
    g = _in_bands(rescore_cuda.rescore_bands(
        N, rows, L1, 16, sms=2, levels=levels, kmax=2, wmax=256), 6, L1,
        levels)
    peq = np.zeros((N, 16), np.int32)
    tiles = np.zeros((N, L1 - 1), np.uint8)
    qmeta = np.array([[20, 5]] * N, np.int32)
    rin = np.zeros((N, L1), np.int64)
    rout = np.full((N, L1), -7, np.int64)
    part = np.full((5, N * g.segs), -7, np.int32)
    good = dict(g._asdict(), y0=g.band, y1=2 * g.band, rin=rin.ctypes.data,
                rout=rout.ctypes.data, part=None, rows=rows,
                nw=g.threads // 32)

    def call(a):
        return band(peq.ctypes.data, tiles.ctypes.data, None,
                    qmeta.ctypes.data, a["rin"], a["rout"], a["part"], N, W,
                    16, levels, a["rows"], L1, L1 - 1, L1 - 1, a["window"],
                    a["own"], a["margin"], a["segs"], a["y0"], a["y1"],
                    a["cols"], a["halo"], a["nw"], a["cluster"], a["smem"],
                    None)
    cone = 1 + g.band * (1 << levels)
    past = g.band + g.margin // (1 << levels) + 1     # past the cone
    assert past < rows
    bad = [dict(margin=cone - 1, own=g.own + g.margin - cone + 1),
           dict(y1=past),
           dict(segs=g.segs - 1), dict(own=g.own + 1),
           dict(y1=g.band), dict(y1=rows + 1, rout=None,
                                 part=part.ctypes.data),
           dict(rin=None), dict(y0=0, y1=g.band),
           dict(rout=None), dict(part=part.ctypes.data),
           dict(y1=rows, rout=None),               # the last band: part
           dict(rows=1 << 16), dict(halo=g.halo + 1), dict(cluster=1),
           dict(cluster=g.cluster + 1)]
    for b in bad:
        assert call(dict(good, **b)) != 0, b
    assert (rout == -7).all() and (part == -7).all()
    assert call(dict(good, y0=0, y1=g.band, rin=None)) == 0
    assert call(good) == 0
    assert call(dict(good, y0=rows - g.band, y1=rows, rout=None,
                     part=part.ctypes.data)) == 0
    assert (part != -7).all()


def test_band_route_covers_every_path_shape():
    """No K3 shape a path can reach plans the global route: look-backs
    of 2 to 256 columns (levels 1-8; the ED budget is capped at 254),
    rows up to 32 W for W up to 141, 16 and 256 codes, L1 from 1,024 to
    2^26. Past the cluster route's windows the band route takes them
    (4,480 rows on 300-600 kbp genomes, 3,104 rows past 184 kbp, 1,456
    rows at a look-back of 128 past 172 kbp), each band plan valid: the
    band's cone within its margin, windows covering the row, a cluster
    of 2 to 16 CTAs covering each window, the key of the whole row's
    gap_q (64 bits only at 16 or 32 columns a thread), shared memory as
    `rescore_wide_smem` counts it, the stored rows of a chunk within
    BAND_ROW_BYTES. Only a look-back of 1,024 past 1,024 columns and
    2^27 columns stay global."""
    g = rescore_cuda.rescore_geometry
    seen = 0
    for W in (1, 5, 46, 97, 140, 141):
        for rows in sorted({8, 16 * W, 32 * W}):
            for codes in (16, 256):
                for levels in range(1, 9):
                    for L1 in (1024, 18432, 152064, 600064, 5 << 20,
                               1 << 24, 1 << 26):
                        for N in (8, 2048):
                            r = g(N, rows, L1, codes * W, levels=levels)
                            assert r.route != "global", \
                                (N, rows, L1, codes, W, levels)
                            if r.route != "bands":
                                continue
                            seen += 1
                            sb, gb, db, w = rescore_cuda.rescore_key_bits(
                                r.window, levels, rows, L1)
                            kb = 32 if sb + gb + db <= 31 else 64
                            nw, C, H, K = (r.threads // 32, r.cols, r.halo,
                                           r.cluster)
                            U = (32 - H) * C
                            assert r.kb == kb and (kb == 32 or C in (16, 32))
                            assert 2 <= K <= 16 and K * nw * U >= \
                                r.window > (K - 1) * nw * U
                            assert H == -(-w // C) <= 16
                            assert r.smem == rescore_cuda.rescore_wide_smem(
                                nw, H, C, codes * W, kb=kb) <= \
                                rescore_cuda.SMEM_MAX
                            assert 1 <= r.band <= rows and r.margin >= \
                                1 + r.band * (1 << levels)
                            assert r.own == r.window - 1 - r.margin >= 32
                            assert r.segs * r.own >= L1 - 1 > \
                                (r.segs - 1) * r.own and r.window < L1
                            assert r.chunk <= N and 16 * L1 * r.chunk <= \
                                rescore_cuda.BAND_ROW_BYTES
                            assert r.grid == r.chunk * r.segs * K
    assert seen > 100
    # the rRNA-operon reads of 4,300-4,480 bp on bacterial genomes
    for L1, lv in ((300032, 5), (600064, 6), (600064, 8)):
        assert g(256, 4480, L1, 16 * 140, levels=lv).route == "bands"
    assert g(64, 300, 4096, 160, levels=10).route == "global"
    assert g(2, 60, 1 << 27, 64, levels=2).route == "global"


MODES = {"BEST": ["-m", "BEST"],
         "CAPITALIST": ["-m", "CAPITALIST", "-b", "{d}/tax.tsv"]}


@pytest.fixture(scope="module")
def operon_data(tmp_path_factory):
    """refs.fa: one random 9 kbp reference; reads.fa: 3 reads of
    1,500-1,560 bp cut from it with 20-29 substitutions (every other one
    reverse complemented, the second with an N); tax.tsv."""
    d = tmp_path_factory.mktemp("bands_long")
    rng = np.random.default_rng(1616)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    ref = rng.choice(bases, 9000)
    (d / "refs.fa").write_bytes(b">genome0\n%s\n" % ref.tobytes())
    (d / "tax.tsv").write_text("genome0\tk__B;p__P;c__C;o__O;f__F;g__G;"
                               "s__S\n")
    with open(d / "reads.fa", "wb") as f:
        for i in range(3):
            ln = int(rng.integers(1500, 1561))
            st = int(rng.integers(0, len(ref) - ln + 1))
            r = ref[st:st + ln].copy()
            for _ in range(int(rng.integers(20, 30))):
                r[int(rng.integers(0, ln))] = bases[int(rng.integers(0, 4))]
            if i % 2:
                r = np.frombuffer(r[::-1].tobytes().translate(comp),
                                  np.uint8).copy()
            if i == 1:
                r[int(rng.integers(0, ln))] = ord("N")
            f.write(b">read%03d\n%s\n" % (i, r.tobytes()))
    cases = {mode: ["-r", str(d / "refs.fa"), "-q", str(d / "reads.fa"),
                    "-o", f"{{o}}/{mode}.b6", "-i", "0.97", "-fr",
                    "--noprogress"] + [a.replace("{d}", str(d))
                                       for a in extra]
             for mode, extra in MODES.items()}
    return d, cases, cli_parity.reference(d, cases)


@pytest.mark.parametrize("mode", list(MODES))
def test_reads_past_1472_bp_bytes(operon_data, mode, monkeypatch):
    """Reads of 1,500-1,560 bp (1,512-1,568 DP rows, past the 1,472 of
    16S reads) on one 9 kbp reference through the direct path: each
    mode's b6 bytes equal burst_tpu's (its jnp scan past 511 rows), every
    read has a row, and each K3 call rescored the reference whole at a
    shape the band route plans on a card granting clusters of 2 CTAs
    (on the card the register route holds 9 kbp)."""
    from burst_tpu_torch import cli
    d, cases, rcs = operon_data
    seen = []
    gather = engine.rescore_pairs_gather

    def recording(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=None,
                  Lw=None):
        seen.append((len(pidx), prescore.rows_for(qlens, W),
                     prescore.l1_for(tiles.shape[1]), peq.shape[1] * W,
                     prescore.levels_for(max_ed), x0 is None))
        return gather(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=x0,
                      Lw=Lw)
    monkeypatch.setattr(engine, "rescore_pairs_gather", recording)
    assert rcs[mode] == 0
    assert cli_parity.ours(d, cases[mode]) == 0
    assert cli.last_stats == {"path": "direct"}
    cli_parity.assert_same_files(d, [f"{mode}.b6"], min_lines=3)
    assert seen and all(full and rows > 1472 for _, rows, *_, full in seen)
    for N, rows, L1, pequ32, lv, _ in seen:
        b = rescore_cuda.rescore_bands(N, rows, L1, pequ32, levels=lv,
                                       kmax=2)
        assert b.route == "bands" and b.band < rows and b.cluster == 2
