"""Port parity for the whole slice: burst_tpu_torch.serving.Aligner on
the CPU (plain kernel versions) emits the same b6 bytes as
burst_tpu.serving.Aligner on its fused device path
(BURST_TPU_DEV_SCOUR=1), on a shrunk bench.py workload: homologous
families, 100 bp reads at 98 % identity, both strands, BEST mode, k=12,
every 37th read with one N (the ambiguous-row branch, K2)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from burst_tpu.accel import build_accelerator
from burst_tpu.process import process_references

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

    rd, acc, qheads, reads = bench_db
    monkeypatch.setenv("BURST_TPU_SCOUR_E", E)
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    # 600 unibin rows: one 1024-row scour chunk in both packages
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    ref = JAligner(rd, acc, thres=0.98, mode="BEST", do_rc=True
                   ).align_batch(qheads, [r.copy() for r in reads])
    al = Aligner(rd, acc, thres=0.98, mode="BEST", do_rc=True,
                 device="cpu")
    got = al.align_batch(qheads, [r.copy() for r in reads])
    assert ref.count(b"\n") > 250
    assert got == ref
    st = al.last_stats
    assert st["side_pairs"] > 0 and st["dev_pairs"] > 0
    assert (st["ov_rows"] > 0) == (E == "512")
    assert myers_cuda.myers_pairs_packed.launches == 0
    assert rescore_cuda.rescore.launches == 0


def test_align_stream_matches_batches(bench_db):
    """Pipelined streaming yields the same bytes as batch calls, in
    order."""
    from burst_tpu_torch.serving import Aligner

    rd, acc, qheads, reads = bench_db
    al = Aligner(rd, acc, thres=0.98, mode="BEST", do_rc=True,
                 device="cpu")
    batches = [(qheads[i:i + 60], [r.copy() for r in reads[i:i + 60]])
               for i in range(0, 180, 60)]
    seq_out = [al.align_batch(h, s) for h, s in batches]
    assert list(al.align_stream(batches)) == seq_out


def test_outside_slice_raises(bench_db):
    from burst_tpu_torch.serving import Aligner

    rd, acc, _, _ = bench_db
    with pytest.raises(NotImplementedError, match="M7"):
        Aligner(rd, acc, mode="ALLPATHS", device="cpu")
    with pytest.raises(NotImplementedError, match="K4"):
        Aligner(rd, None, device="cpu")
    al = Aligner(rd, acc, thres=0.98, mode="BEST", device="cpu")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    short = [np.tile(bases, 2)]            # 8 bp < k: a full-scan row
    with pytest.raises(NotImplementedError, match="K4"):
        al.align_batch([b"s"], short)


def test_import_without_jax():
    """`import burst_tpu_torch` and a tiny CPU slice run with JAX made
    unimportable; no jax module loads."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from burst_tpu.accel import build_accelerator
        from burst_tpu.process import process_references
        from burst_tpu_torch.serving import Aligner
        rng = np.random.default_rng(3)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        refs = [rng.choice(bases, size=500) for _ in range(8)]
        rd = process_references([b"r%d" % i for i in range(8)], refs,
                                max_len_q=100, thres=0.98, rebase=True,
                                rebase_amt=320, curate=2)
        acc = build_accelerator(rd, k=12, z=1)
        reads = [refs[i % 8][50:150].copy() for i in range(40)]
        out = Aligner(rd, acc, thres=0.98, do_rc=True, device="cpu"
                      ).align_batch([b"q%d" % i for i in range(40)], reads)
        assert out.count(b"\\n") == 40, out
        loaded = [m for m, v in sys.modules.items()
                  if v is not None and (m == "jax" or m.startswith("jax"))]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
