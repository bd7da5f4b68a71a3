"""CLI parity with an accelerator: `python -m burst_tpu_torch.cli` (in
process on the CPU) writes the same b6 bytes as `python -m burst_tpu.cli`
(jax-CPU with its device scour on, BURST_TPU_DEV_SCOUR=1, so that it
takes the fused path wherever it would on a TPU), on the reference's own
.edx/.acx (k=12) of homologous families with N reads, reads under k and
both strands (`cli_parity.make_dataset`: 440 unibin rows). Exact byte
equality throughout.

  (a) BEST, ALLPATHS, CAPITALIST -b and ANY at -t 1 (QBUNCH 3: the
      two-step path) and at -t 4 (QBUNCH 1: the fused path in every
      mode, whose visit order ALLPATHS, CAPITALIST and ANY print in);
      each case asserts the path it took from `cli.last_stats`;
  (b) the heuristic cut -hr -i 0.84 in BEST and in ALLPATHS -fr; -sa;
      prepass -p in BEST -fr and CAPITALIST -b;
  (c) raw-byte queries (-x) on `test_golden_flags`' protein generator,
      BEST and ALLPATHS -i 0.90, with and without an accelerator: with
      one, burst_tpu bins every row for the full scan, so the port runs
      K4 (256 codes) alone and no pair."""
import numpy as np
import pytest
import torch

from tests import cli_parity

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

# slot budgets that no row of this workload overflows, small chunks
SCOUR_ENV = {"BURST_TPU_DEV_SCOUR": "1", "BURST_TPU_SCOUR_E": "1024",
             "BURST_TPU_SCOUR_EB": "8192", "BURST_TPU_SCOUR_CHUNK": "1024",
             "BURST_TPU_SCOUR_BCHUNK": "64"}
ACCEL = {
    "BEST": ["-m", "BEST"],
    "ALLPATHS": ["-m", "ALLPATHS"],
    "CAPITALIST": ["-m", "CAPITALIST", "-b", "{d}/tax.tsv"],
    "ANY": ["-m", "ANY"],
}
THREADS = {"1": "two-step", "4": "fused"}
FLAGS = {
    "hr-BEST": ["-m", "BEST", "-hr", "-i", "0.84"],
    "hr-ALLPATHS-fr": ["-m", "ALLPATHS", "-fr", "-hr", "-i", "0.84"],
    "sa-BEST-fr": ["-m", "BEST", "-fr", "-sa"],
    "p-BEST-fr": ["-m", "BEST", "-fr", "-p"],
    "p-CAPITALIST": ["-m", "CAPITALIST", "-p", "-b", "{d}/tax.tsv"],
}
XALPHA = {
    "BEST": ["-m", "BEST"],
    "ALLPATHS": ["-m", "ALLPATHS", "-i", "0.90"],
}


def _cases(d):
    edx, acx = str(d / "ref" / "db.edx"), str(d / "ref" / "db.acx")
    cases = {
        "makedb": ["-r", str(d / "refs.fa"), "-o", edx, "-a", acx, "-d",
                   "DNA", "320", "-s", "--kmer", "12"],
        "makedb-x": ["-r", str(d / "prot.fa"), "-o", str(d / "ref/x.edx"),
                     "-a", str(d / "ref" / "x.acx"), "-x", "-d", "QUICK",
                     "120", "-s", "300", "--kmer", "12"]}

    def add(name, db, reads, extra):
        cases[name] = ["-r", *db, "-q", str(d / reads), "-o",
                       f"{{o}}/{name}.b6", "--noprogress"] + \
            [a.replace("{d}", str(d)) for a in extra]

    for mode, extra in ACCEL.items():
        for t in THREADS:
            add(f"{mode}-t{t}", [edx, "-a", acx], "reads.fa",
                extra + ["-fr", "-t", t])
    for name, extra in FLAGS.items():
        add(name, [edx, "-a", acx], "reads.fa", extra)
    for mode, extra in XALPHA.items():
        add(f"x-{mode}", [str(d / "prot.fa")], "pread.fa", extra + ["-x"])
        add(f"x-{mode}-a", [str(d / "prot.fa"), "-a",
                            str(d / "ref" / "x.acx")], "pread.fa",
            extra + ["-x"])
    return cases


@pytest.fixture(scope="module")
def accel_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_accel")
    cli_parity.make_dataset(d)
    cli_parity.make_protein(d)
    cases = _cases(d)
    return d, cases, cli_parity.reference(d, cases, SCOUR_ENV)


@pytest.fixture(autouse=True)
def _scour_env(monkeypatch):
    for k, v in SCOUR_ENV.items():
        monkeypatch.setenv(k, v)


def _run(accel_data, name, rc=0, min_lines=100):
    from burst_tpu_torch import cli
    d, cases, rcs = accel_data
    assert rcs["makedb"] == 0 and rcs[name] == rc
    assert cli_parity.ours(d, cases[name]) == rc
    cli_parity.assert_same_files(d, [name + ".b6"], min_lines)
    return cli.last_stats


@pytest.mark.parametrize("t", list(THREADS))
@pytest.mark.parametrize("mode", list(ACCEL))
def test_cli_accel_bytes(accel_data, mode, t):
    st = _run(accel_data, f"{mode}-t{t}")
    assert st["path"] == THREADS[t]
    # 440 unibin rows: QBUNCH 440 // (128 t), clamped to 1..16
    assert st["qbunch"] == (3 if t == "1" else 1)
    assert st["full_rows"] > 0
    if t == "4":
        assert st["dev_pairs"] > 0 and st["side_pairs"] > 0


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_flag_bytes(accel_data, name):
    prepass = name.startswith("p-")
    st = _run(accel_data, name, rc=101 if prepass else 0)
    if name.startswith("hr-"):
        assert st["path"] == "two-step" and st["pairs"] > 0
    if prepass:
        assert st == {}


@pytest.mark.parametrize("accel", ["", "-a"])
@pytest.mark.parametrize("mode", list(XALPHA))
def test_cli_xalpha_bytes(accel_data, mode, accel):
    st = _run(accel_data, f"x-{mode}{accel}", min_lines=20)
    if accel:
        # every row in the full scan: K4 at 256 codes, no pair for K2
        assert st["path"] == "two-step" and st["pairs"] == 0
        assert st["full_rows"] == 40
    else:
        assert st == {"path": "direct"}


def test_xalpha_rows_all_full_scan_in_burst_tpu(accel_data):
    """burst_tpu bins every raw-byte read of the protein set into the
    full-scan bin (more than five codes above 4 + z), so with -x -a no
    row reaches its pair kernel: K4 and K3 are the kernels that need
    256 codes, not K1/K2."""
    from burst_tpu.io.fasta import parse_fasta
    from burst_tpu.process import bin_queries_for_accel, process_queries
    d = accel_data[0]
    for do_heur in (False, True):
        qh, qs = parse_fasta(str(d / "pread.fa"))
        qd = process_queries(qh, qs, 0.9, False, xalpha=True)
        qbins = bin_queries_for_accel(qd, 12, 1, do_heur)
        assert qbins.tolist() == [0, 0]
        assert len(qd.seqs) == 40 and np.all([s.max() > 5 for s in qd.seqs])
