"""The harness end to end on the CPU, in a copy of the benchmark: a cell
and a per-layer metric added as new files only are found and run; the
timed path broken underneath (half of each batch dropped, an answer
altered) and the control each come out not correct; a copy without the
program prints no result; the import guard tells `burst_tpu_torch` from
`burst_tpu`. The control at each cell's own size runs on the card."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_CELLS = ("tiny.best", "tiny.cap")


def _checkout(tmp, with_program=True):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    if with_program:
        os.symlink(os.path.join(ROOT, "burst_tpu_torch"),
                   tmp / "burst_tpu_torch")
    return tmp


# a small shotgun-style configuration and cell of the tests' own
TINY_CONFIG = {
    "name": "tiny", "db_seed": 20260817, "families": 5, "members": 4,
    "member_len": 2500, "divergence": 0.01,
    "head_format": "f{f:05d}m{m:02d}",
    "lineage_format": "k__Bacteria;p__P{p};c__C{c};o__O{o};f__F{fa};"
                      "g__G{f};s__S{f}_{m}",
    "max_len_q": 100, "thres": 0.98, "rebase_amt": 320, "curate": 2,
    "k": 12, "z": 1, "reduced": []}
TINY_TRAFFIC = {
    "mode": "BEST", "read_len": 100, "max_subs": 2, "rc_share": 0.5,
    "n_every": 37, "short_every": 97, "short_first": 5, "short_len": 11,
    "batch_reads": 240, "depth": 2, "prefetch_batches": 2, "taxacut": 10,
    "check_reads": 40}


def _add_tiny_cells(tmp):
    """A configuration, two cells and a per-layer metric, as files, and
    their entries in BENCHMARK.json."""
    b = tmp / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    tr = dict(TINY_TRAFFIC)
    (b / "traffic" / "tiny.best.json").write_text(json.dumps(tr))
    tr.update(mode="CAPITALIST")
    (b / "traffic" / "tiny.cap.json").write_text(json.dumps(tr))
    (b / "metrics" / "reads_traced.py").write_text(
        "def read(run):\n"
        "    return run.traced_reads if run.trace is not None else None\n")
    man = json.loads((tmp / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "test"})
    for c in TINY_CELLS:
        man["workloads"].append({"name": c, "config": "tiny", "traffic": c,
                                 "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "reads_traced", "unit": "reads",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving", "moves": "reads_per_s",
                             "workloads": list(TINY_CELLS)})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))


def _run(tmp, *args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BURST_TPU_")}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--seed", "3000000007",
         "--seconds", "1", "--device", "cpu", *args],
        cwd=tmp, capture_output=True, text=True, timeout=600, env=env)
    last = p.stdout.strip().splitlines()[-1:] if p.stdout.strip() else []
    return p, (json.loads(last[0]) if last else None)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = _checkout(tmp_path_factory.mktemp("checkout"))
    _add_tiny_cells(tmp)
    return tmp


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_added_cell_and_metric_run(tiny, cell):
    p, out = _run(tiny, "--workload", cell, "--trace", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    assert out["correct"] is True
    # the cell reports the per-layer metrics that name it, and only them
    assert list(out["metrics"]) == ["reads_traced"]
    assert out["metrics"]["reads_traced"]["value"] >= 240
    assert out["checks"]["rows_wrong"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("correct:")


@pytest.mark.parametrize("cell,how", [
    ("tiny.best", ["--fault", "drop_half"]),
    ("tiny.cap", ["--fault", "alter"]),
    ("tiny.best", ["--control", "1"]),
    ("tiny.cap", ["--control", "1"])])
def test_broken_path_and_control_are_not_correct(tiny, cell, how):
    p, out = _run(tiny, "--workload", cell, *how)
    assert p.returncode == 0, p.stderr[-2000:]
    assert out["correct"] is False
    assert out["checks"]["rows_wrong"]["value"] > 0


def test_no_result_without_the_program(tmp_path):
    tmp = _checkout(tmp_path, with_program=False)
    p, out = _run(tmp, "--workload", "amplicon.best292")
    assert p.returncode != 0 and out is None


def test_import_guard_compares_whole_names(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(ROOT, "benchmark", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "burst_tpu_torch_probe",
                        types.ModuleType("burst_tpu_torch_probe"))
    run.guard_imports("test")
    monkeypatch.setitem(sys.modules, "burst_tpu.engine",
                        types.ModuleType("burst_tpu.engine"))
    with pytest.raises(SystemExit):
        run.guard_imports("test")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["amplicon.capitalist292",
                                  "amplicon.best292"])
def test_control_fails_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3000000041", "--seconds", "10", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
