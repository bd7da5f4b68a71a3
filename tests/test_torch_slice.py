"""Port parity for the accelerated slice: burst_tpu_torch.serving.Aligner
on the CPU (plain kernel versions) emits the same b6 bytes as
burst_tpu.serving.Aligner on its fused device path
(BURST_TPU_DEV_SCOUR=1), on a shrunk bench.py workload: homologous
families, 100 bp reads at 98 % identity, both strands, BEST mode, k=12,
every 37th read with one N (the ambiguous-row branch, K2). The database
is built by burst_tpu and handed to the port through
`state.from_reference`. Also: the port stands alone -- it imports
neither jax nor burst_tpu."""
import glob
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from burst_tpu.accel import build_accelerator
from burst_tpu.process import process_references

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench_db():
    prev = os.environ.get("BURST_TPU_SCOUR_E")
    import bench                      # sets BURST_TPU_SCOUR_E at import
    if prev is None:
        os.environ.pop("BURST_TPU_SCOUR_E", None)
    else:
        os.environ["BURST_TPU_SCOUR_E"] = prev
    saved = (bench.N_FAM, bench.N_MEM, bench.FAM_LEN, bench.N_READS)
    bench.N_FAM, bench.N_MEM, bench.FAM_LEN, bench.N_READS = 3, 4, 2000, 300
    try:
        rheads, refs, qheads, reads = bench.make_workload()
    finally:
        bench.N_FAM, bench.N_MEM, bench.FAM_LEN, bench.N_READS = saved
    rng = np.random.default_rng(37)
    for i in range(0, len(reads), 37):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=100, thres=0.98, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    return rd, acc, qheads, reads


@pytest.mark.parametrize("E", ["3072", "512"])  # bench budget / overflow
def test_slice_b6_matches_jax(bench_db, E, monkeypatch):
    from burst_tpu.kernels import scour_device as jsd
    from burst_tpu.serving import Aligner as JAligner
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    from burst_tpu_torch.serving import Aligner
    from burst_tpu_torch.state import from_reference

    rd, acc, qheads, reads = bench_db
    monkeypatch.setenv("BURST_TPU_SCOUR_E", E)
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    # 600 unibin rows: one 1024-row scour chunk in both packages
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    ref = JAligner(rd, acc, thres=0.98, mode="BEST", do_rc=True
                   ).align_batch(qheads, [r.copy() for r in reads])
    al = Aligner(*from_reference(rd, acc), thres=0.98, mode="BEST",
                 do_rc=True, device="cpu")
    got = al.align_batch(qheads, [r.copy() for r in reads])
    assert ref.count(b"\n") > 250
    assert got == ref
    st = al.last_stats
    assert st["side_pairs"] > 0 and st["dev_pairs"] > 0
    assert (st["ov_rows"] > 0) == (E == "512")
    assert myers_cuda.myers_pairs_packed.launches == 0
    assert rescore_cuda.rescore.launches == 0


def test_slice_long_reads_with_n_matches_jax(monkeypatch):
    """150-300 bp reads (W = 5..10), most of them carrying an N: the
    clear rows go through K1 at W = 10 and the ambiguous rows' side
    pairs through `_pairs_min_ed` and K2, bucketed by W; same b6 bytes
    as burst_tpu."""
    from burst_tpu.kernels import scour_device as jsd
    from burst_tpu.serving import Aligner as JAligner
    from burst_tpu_torch import engine
    from burst_tpu_torch.serving import Aligner
    from burst_tpu_torch.state import from_reference

    rng = np.random.default_rng(292)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fams = [rng.choice(bases, size=1500) for _ in range(3)]
    refs, rheads = [], []
    for f, anc in enumerate(fams):
        for m in range(3):
            r = anc.copy()
            pos = rng.integers(0, len(r), 15)
            r[pos] = bases[rng.integers(0, 4, 15)]
            refs.append(r)
            rheads.append(b"f%dm%d" % (f, m))
    reads, qheads = [], []
    for i in range(90):
        src = refs[int(rng.integers(0, len(refs)))]
        n = int(rng.integers(150, 301))
        st = int(rng.integers(0, len(src) - n))
        r = src[st:st + n].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, n))] = bases[int(rng.integers(0, 4))]
        if i % 3:
            r[int(rng.integers(0, n))] = ord("N")
        reads.append(r)
        qheads.append(b"q%03d" % i)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=300, thres=0.98, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "3072")
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    ref = JAligner(rd, acc, thres=0.98, mode="BEST", do_rc=True
                   ).align_batch(qheads, [r.copy() for r in reads])
    side_w = set()
    pairs_min_ed = engine._pairs_min_ed

    def seen(qd, db, pj, pp):
        side_w.update(engine._query_matrix(qd)[2][pj].tolist())
        return pairs_min_ed(qd, db, pj, pp)
    monkeypatch.setattr(engine, "_pairs_min_ed", seen)
    al = Aligner(*from_reference(rd, acc), thres=0.98, mode="BEST",
                 do_rc=True, device="cpu")
    got = al.align_batch(qheads, [r.copy() for r in reads])
    assert ref.count(b"\n") > 60
    assert got == ref
    assert al.last_stats["side_pairs"] > 0 and al.last_stats["dev_pairs"] > 0
    assert min(side_w) >= 5 and max(side_w) == 10 and len(side_w) >= 4


def test_align_stream_matches_batches(bench_db):
    """Pipelined streaming yields the same bytes as batch calls, in
    order."""
    from burst_tpu_torch.serving import Aligner
    from burst_tpu_torch.state import from_reference

    rd, acc, qheads, reads = bench_db
    al = Aligner(*from_reference(rd, acc), thres=0.98, mode="BEST",
                 do_rc=True, device="cpu")
    batches = [(qheads[i:i + 60], [r.copy() for r in reads[i:i + 60]])
               for i in range(0, 180, 60)]
    seq_out = [al.align_batch(h, s) for h, s in batches]
    assert list(al.align_stream(batches)) == seq_out


def test_outside_slice_raises(bench_db):
    """What the port does not cover yet raises NotImplementedError
    naming its ROADMAP item; what it now covers no longer does (every
    mode with an accelerator, and a batch without a clear row, are held
    to burst_tpu's bytes in test_torch_twostep.py)."""
    from burst_tpu_torch.serving import MODES, Aligner
    from burst_tpu_torch.state import from_reference

    prd, pacc = from_reference(*bench_db[:2])
    for mode in MODES:
        assert Aligner(prd, pacc, mode=mode, device="cpu").mode == mode
    with pytest.raises(ValueError, match="unknown mode"):
        Aligner(prd, None, mode="WORST", device="cpu")
    # no accelerator, and a read under k (a full-scan row), now align
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    batch = [np.tile(bases, 2), bench_db[3][1].copy()]
    for acc in (None, pacc):
        al = Aligner(prd, acc, thres=0.98, mode="BEST", device="cpu")
        al.align_batch([b"s", b"t"], [r.copy() for r in batch])
    assert al.last_stats["full_rows"] == 1
    # a batch of nothing but such rows takes the two-step path: one
    # full-scan row, the direct path's bytes
    direct = Aligner(prd, None, thres=0.98, mode="BEST", device="cpu")
    assert al.align_batch([b"s"], batch[:1]) == \
        direct.align_batch([b"s"], batch[:1]) != b""
    assert al.last_stats == dict(qbunch=1, pairs=0, full_rows=1)
    # reads of 257-512 bp (W = 9..16) are inside the pair kernel's range
    # now; longer ones still raise, on either path
    rng = np.random.default_rng(5)
    for acc in (None, pacc):
        al = Aligner(prd, acc, thres=0.98, mode="BEST", device="cpu")
        al.align_batch([b"u"], [rng.choice(bases, size=300)])
        with pytest.raises(NotImplementedError, match="W=17"):
            al.align_batch([b"v"], [rng.choice(bases, size=520)])


def test_import_without_jax():
    """Every module of burst_tpu_torch imports, and a tiny CPU batch runs
    on both paths, with `jax` and `burst_tpu` made unimportable."""
    code = textwrap.dedent("""
        import glob, importlib, os, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "burst_tpu"):
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        import burst_tpu_torch
        root = os.path.dirname(burst_tpu_torch.__path__[0])
        names = [os.path.relpath(p, root)[:-3].replace(os.sep, ".")
                 for p in glob.glob(burst_tpu_torch.__path__[0] + "/**/*.py",
                                    recursive=True)]
        names = [n[:-9] if n.endswith(".__init__") else n for n in names]
        assert len(names) >= 25, names
        for name in names:
            importlib.import_module(name)
        from burst_tpu_torch.accel import build_accelerator
        from burst_tpu_torch.process import process_references
        from burst_tpu_torch.serving import Aligner
        rng = np.random.default_rng(3)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        refs = [rng.choice(bases, size=500) for _ in range(8)]
        rd = process_references([b"r%d" % i for i in range(8)], refs,
                                max_len_q=100, thres=0.98, rebase=True,
                                rebase_amt=320, curate=2)
        acc = build_accelerator(rd, k=12, z=1)
        reads = [refs[i % 8][50:150].copy() for i in range(40)]
        heads = [b"q%d" % i for i in range(40)]
        out = Aligner(rd, acc, thres=0.98, do_rc=True, device="cpu"
                      ).align_batch(heads, reads)
        assert out.count(b"\\n") == 40, out
        direct = Aligner(rd, None, thres=0.98, do_rc=True, device="cpu"
                         ).align_batch(heads, reads)
        assert direct.count(b"\\n") == 40, direct
        from burst_tpu_torch.io.taxonomy import Taxonomy
        tax = Taxonomy([(b"r%d" % i, b"k__K;p__P%d" % (i % 2))
                        for i in range(8)])
        cap = Aligner(rd, acc, thres=0.98, mode="CAPITALIST", do_rc=True,
                      taxonomy=tax, device="cpu")
        out = cap.align_batch(heads, reads)
        assert out.count(b"\\n") == 40 and b"k__K;p__P1" in out, out
        assert cap.last_stats["pairs"] > 0, cap.last_stats
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "burst_tpu")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_port_sources_import_nothing_of_burst_tpu():
    """No file of the port, nor chip_smoke.py, imports `burst_tpu`,
    `bench` or `jax` (docstrings may name counterparts)."""
    files = glob.glob(os.path.join(REPO, "burst_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    pat = re.compile(r"^\s*(from|import)\s+(burst_tpu|bench|jax|jaxlib)"
                     r"(\.|\s|$)")
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{os.path.relpath(path, REPO)}:{n}: {ln.strip()}"
                    for n, ln in enumerate(f, 1) if pat.match(ln)]
    assert not bad, bad
