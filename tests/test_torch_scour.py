"""Port parity: burst_tpu_torch's fused device scour + K1 chain
(`scour_align_rows`, plain versions on the CPU) equals burst_tpu's
XLA chain under BURST_TPU_DEV_SCOUR=1 field for field: overflow flags,
candidate tuples, passing unit keys, device pairs and their (ed, first,
last). Covers the dense rank table (k=12), the binary-search lookup
(k=15) and slot-budget overflow (E=96)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_tpu import engine as jengine
from burst_tpu.accel import build_accelerator
from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import scour_device as jsd
from burst_tpu.process import (bin_queries_for_accel, process_queries,
                               process_references)
from burst_tpu_torch import engine as pengine
from burst_tpu_torch.kernels import scour_device as psd
from burst_tpu_torch.state import from_reference

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


def _workload(seed, k, n_refs=30, ref_len=600, n_reads=300):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(bases, size=ref_len) for _ in range(n_refs)]
    reads = []
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, ref_len - 100))
        r = s[st:st + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 100))] = bases[int(rng.integers(0, 4))]
        reads.append(r)
    rd = process_references([f"r{i:03d}".encode() for i in range(n_refs)],
                            refs, max_len_q=100, thres=0.98, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=k, z=1)
    jengine.rd_acc_unit_index(rd, acc)
    qd = process_queries([f"q{i}".encode() for i in range(n_reads)],
                         reads, 0.98, do_rc=True)
    qbins = bin_queries_for_accel(qd, k, 1)
    return qd, rd, acc, qbins


@pytest.mark.parametrize("k,E", [(12, 256), (15, 256), (12, 96)])
def test_scour_align_rows_matches_jax(k, E, monkeypatch):
    # 600 unibin rows: one 1024-row chunk in both packages
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
    monkeypatch.setattr(jsd, "CHUNK_ROWS", 1024)
    qd, rd, acc, qbins = _workload(40 + k + E, k)
    smat = score_matrix()
    b0, b1 = int(qbins[0]), int(qbins[1])
    assert b1 == len(qd.seqs) and b1 - b0 > 100
    qmat, qlens, qw = jengine._query_matrix(qd)
    W = int(qw[:b1].max())
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    kload = qd.ed[qd.six[:b1]].astype(np.int64) * k + k
    mm_m = np.where(kload < lns, lns - kload, 0)[b0:b1]
    mm_i = np.where(kload < lns, lns - kload, 1)[b0:b1]
    n_clumps = -(-rd.tot_units // 16)
    qm, ql = qmat[b0:b1], qlens[b0:b1]

    jtiles, lp = jengine._tiles_device_all(rd)
    ref = jsd.scour_align_rows(
        qm, ql, k, mm_m, mm_i, jsd.get_tables(acc), n_clumps,
        rd.tot_units, jnp.asarray(smat), (jtiles, lp), W, E=E)()

    cpu = torch.device("cpu")
    prd, pacc = from_reference(rd, acc)
    ptiles, plp = pengine._tiles_device_all(prd, cpu)
    assert plp == lp
    np.testing.assert_array_equal(ptiles.numpy(), np.asarray(jtiles))
    got = psd.scour_align_rows(
        qm, ql, k, mm_m, mm_i, psd.get_tables(pacc, cpu), rd.tot_units,
        torch.from_numpy(smat), ptiles, W, E=E)()
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)
    assert len(got["uj"]) > 0
    if E == 96:
        assert got["ov"].any() and not got["ov"].all()


def test_cap_escalation_sticks(monkeypatch):
    """Winner buffers that overflow at factor 2 redo once at 4; the
    tables remember it. Chimeric reads from two references each, with
    mm=0, win ~3 clumps per row: between the x2 and x4 caps."""
    rng = np.random.default_rng(43)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(bases, size=600) for _ in range(40)]
    reads = []
    for _ in range(256):
        parts = [refs[int(rng.integers(0, 40))][st:st + 25]
                 for st in rng.integers(0, 575, 2)]
        reads.append(np.concatenate(parts + [rng.choice(bases, 50)]))
    rd = process_references([f"r{i:03d}".encode() for i in range(40)],
                            refs, max_len_q=100, thres=0.98, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    jengine.rd_acc_unit_index(rd, acc)
    qd = process_queries([f"q{i}".encode() for i in range(256)], reads,
                         0.98, do_rc=False)
    qbins = bin_queries_for_accel(qd, 12, 1)
    monkeypatch.setenv("BURST_TPU_SCOUR_CHUNK", "64")
    b0, b1 = int(qbins[0]), int(qbins[1])
    qmat, qlens, qw = jengine._query_matrix(qd)
    z = np.zeros(b1 - b0, np.int64)
    cpu = torch.device("cpu")
    rd, acc = from_reference(rd, acc)
    tabs = psd.get_tables(acc, cpu)
    ptiles, _ = pengine._tiles_device_all(rd, cpu)
    args = (qmat[b0:b1], qlens[b0:b1], 12, z, z)
    rest = (rd.tot_units, torch.from_numpy(score_matrix()), ptiles,
            int(qw.max()))
    res = psd.scour_align_rows(*args, tabs, *rest)()
    assert tabs.cap_factor == 4
    assert len(res["cj"]) > 2 * 64
    tabs2 = psd.get_tables(acc, cpu)
    tabs2.cap_factor = 4
    res2 = psd.scour_align_rows(*args, tabs2, *rest)()
    for key in res:
        np.testing.assert_array_equal(res[key], res2[key])
