"""CLI parity, database build and direct path: `python -m
burst_tpu_torch.cli` (in process on the CPU, the kernels' plain
versions) writes the same .edx, .acx and b6 bytes as `python -m
burst_tpu.cli` (jax-CPU, one subprocess for the module's cases), on
homologous families with N reads, short reads and both strands
(`cli_parity.make_dataset`). Exact byte equality throughout.

  (a) makedb: -d DNA 320 -s, -d QUICK 120 -s 400, an accelerator at
      --kmer 12 (with -sa too), -u, -f, -dp 3, and a raw-byte (-x)
      database;
  (b) the direct path (no accelerator), on the reference's .edx: BEST,
      ALLPATHS, FORAGE -i 0.9, CAPITALIST -b and ANY, each with and
      without -fr;
  (c) error paths: a missing FASTA (exit 2), -m MATRIX and an unknown
      flag (exit 1), a bad BURST_TPU_MULTIHOST spec (the reference's
      ValueError; a multi-host makedb exits 1), no card without a request
      for the CPU (exit 1); --shards 2 and --qshards 2 on the direct
      path (the reference's bytes);
  (d) one run as a `python -m burst_tpu_torch.cli` subprocess with
      BURST_TPU_TORCH_DEVICE=cpu."""
import os
import subprocess
import sys

import pytest
import torch

from tests import cli_parity

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

DB_ARGS = ["-d", "DNA", "320", "-s"]
MAKEDB = {
    "dna320": DB_ARGS,
    "quick120": ["-d", "QUICK", "120", "-s", "400"],
    "accel12": DB_ARGS + ["-a", "{o}/accel12.acx", "--kmer", "12"],
    "skipambig": DB_ARGS + ["-a", "{o}/skipambig.acx", "--kmer", "12",
                            "-sa"],
    "unique": DB_ARGS + ["-u"],
    "fingerprint": DB_ARGS + ["-f"],
    "dbpartition": DB_ARGS + ["-dp", "3"],
}
DIRECT = {
    "BEST": ["-m", "BEST"],
    "ALLPATHS": ["-m", "ALLPATHS"],
    "FORAGE": ["-m", "FORAGE", "-i", "0.9"],
    "CAPITALIST": ["-m", "CAPITALIST", "-b", "{d}/tax.tsv"],
    "ANY": ["-m", "ANY"],
}
ERRORS = {
    "missing-fasta": ["-r", "{d}/refs.fa", "-q", "{d}/absent.fa", "-o",
                      "{o}/missing.b6"],
    "matrix": ["-r", "{d}/refs.fa", "-q", "{d}/reads.fa", "-o",
               "{o}/matrix.b6", "-m", "MATRIX"],
    "unknown-flag": ["-r", "{d}/refs.fa", "-q", "{d}/reads.fa", "-o",
                     "{o}/unknown.b6", "--bogus"],
}


def _cases(d):
    cases = {}
    for name, extra in MAKEDB.items():
        cases["makedb-" + name] = ["-r", str(d / "refs.fa"), "-o",
                                   f"{{o}}/{name}.edx"] + extra
    cases["makedb-xalpha"] = ["-r", str(d / "prot.fa"), "-o",
                              "{o}/xalpha.edx", "-x", "-d", "QUICK", "120",
                              "-s", "300", "-a", "{o}/xalpha.acx", "--kmer",
                              "12"]
    for mode, extra in DIRECT.items():
        for fr in ((), ("-fr",)):
            cases[f"direct-{mode}{''.join(fr)}"] = [
                "-r", str(d / "ref" / "dna320.edx"), "-q",
                str(d / "reads.fa"), "-o", f"{{o}}/{mode}{''.join(fr)}.b6",
                "--noprogress", *fr] + \
                [a.replace("{d}", str(d)) for a in extra]
    for name, argv in ERRORS.items():
        cases["error-" + name] = [a.replace("{d}", str(d)) for a in argv]
    return cases


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cli_parity.make_dataset(d)
    cli_parity.make_protein(d)
    cases = _cases(d)
    return d, cases, cli_parity.reference(d, cases)


@pytest.mark.parametrize("name", list(MAKEDB) + ["xalpha"])
def test_cli_makedb_bytes(cli_data, name):
    d, cases, rcs = cli_data
    assert rcs["makedb-" + name] == 0
    assert cli_parity.ours(d, cases["makedb-" + name]) == 0
    files = [name + ".edx"]
    if (d / "ref" / (name + ".acx")).exists():
        files.append(name + ".acx")
    cli_parity.assert_same_files(d, files)


@pytest.mark.parametrize("fr", ["", "-fr"])
@pytest.mark.parametrize("mode", list(DIRECT))
def test_cli_direct_bytes(cli_data, mode, fr):
    from burst_tpu_torch import cli
    d, cases, rcs = cli_data
    case = f"direct-{mode}{fr}"
    assert rcs[case] == 0
    assert cli_parity.ours(d, cases[case]) == 0
    assert cli.last_stats == {"path": "direct"}
    cli_parity.assert_same_files(d, [f"{mode}{fr}.b6"], min_lines=100)


def test_cli_missing_fasta(cli_data, capsys):
    d, cases, rcs = cli_data
    assert rcs["error-missing-fasta"] == 2
    assert cli_parity.ours(d, cases["error-missing-fasta"]) == 2
    assert "Cannot open FASTA file" in capsys.readouterr().err


@pytest.mark.parametrize("name,msg", [
    ("matrix", "Matrix mode is no longer supported"),
    ("unknown-flag", "Unrecognized command-line option: --bogus")])
def test_cli_rejected_flags(cli_data, capsys, name, msg):
    d, cases, rcs = cli_data
    assert rcs["error-" + name] == 1
    assert cli_parity.ours(d, cases["error-" + name]) == 1
    out = capsys.readouterr()
    assert msg in out.out + out.err


@pytest.mark.parametrize("flag", [["--shards", "2"], ["--qshards", "2"],
                                  "BURST_TPU_MULTIHOST"])
def test_cli_shards_name_m12(cli_data, flag, monkeypatch):
    """`--shards 2` runs the direct path on a grid of two CPU devices and
    `--qshards 2` alone the unsharded flow, both with the reference's
    bytes; a BURST_TPU_MULTIHOST spec that names no world raises the
    reference's ValueError, and a multi-host makedb exits 1, as
    burst_tpu's does (tests/test_torch_multihost.py runs the worlds)."""
    from burst_tpu.parallel.multihost import parse_spec
    from burst_tpu_torch import cli
    d, cases, rcs = cli_data
    if flag == "BURST_TPU_MULTIHOST":
        monkeypatch.setenv(flag, "1")
        assert cli_parity.ours(d, cases["makedb-dna320"]) == 1
        with pytest.raises(ValueError) as ref:
            parse_spec("1")
        with pytest.raises(ValueError) as got:
            cli_parity.ours(d, cases["direct-BEST"])
        assert str(got.value) == str(ref.value)
        return
    argv = [a.replace("/BEST.b6", "/BEST-grid.b6")
            for a in cases["direct-BEST"]] + flag
    assert rcs["direct-BEST"] == 0 and cli_parity.ours(d, argv) == 0
    assert (d / "port" / "BEST-grid.b6").read_bytes() == \
        (d / "ref" / "BEST.b6").read_bytes()
    if flag[0] == "--shards":
        assert cli.last_stats == {"path": "direct", "grid": [1, 2],
                                  "devices": 1}
    else:
        assert cli.last_stats == {"path": "direct"}


def test_cli_needs_a_card_unless_asked(cli_data, monkeypatch, capsys):
    """Without a card and without a request for the CPU the run fails
    with exit code 1 and says why; it does not carry on on the CPU."""
    from burst_tpu_torch import cli
    d, cases, _ = cli_data
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("{o}", str(d)) for a in cases["direct-BEST"]]
    argv[argv.index("-o") + 1] = str(d / "nocard.b6")
    assert cli.main(["burst_tpu_torch"] + argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (d / "nocard.b6").exists()


def test_cli_module_subprocess(cli_data):
    """`python -m burst_tpu_torch.cli` with BURST_TPU_TORCH_DEVICE=cpu
    writes the reference's bytes (ALLPATHS -fr: the tie sets)."""
    d, cases, _ = cli_data
    argv = [a.replace("{o}", str(d / "sub"))
            for a in cases["direct-ALLPATHS-fr"]]
    (d / "sub").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run(
        [sys.executable, "-m", "burst_tpu_torch.cli", *argv], cwd=str(d),
        capture_output=True, text=True,
        env={**env, "BURST_TPU_TORCH_DEVICE": "cpu",
             "PYTHONPATH": cli_parity.REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert (d / "sub" / "ALLPATHS-fr.b6").read_bytes() == \
        (d / "ref" / "ALLPATHS-fr.b6").read_bytes()
