"""The reduction of the program's layer spans (`harness/spans.py`) on
synthetic kept spans: self times of nested and sibling spans on two
batch threads, the batches' counts summed; the spans taken from the
program once a run, and nothing read from a program that keeps none;
and the new readers end to end on the CPU, in a copy of the benchmark
whose tiny cells list them."""
import importlib.util
import json
import os
import sys
import types

import pytest

from harness import spans

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("prep_host_ms_per_kread", "words_host_ms_per_kread",
       "scour_host_ms_per_kread", "pairs_host_ms_per_kread",
       "select_host_ms_per_kread", "rescore_host_ms_per_kread",
       "report_host_ms_per_kread", "wait_ms_per_kread",
       "pairs_per_read", "scour_overflow_per_kread")
COUNTS = {"batches": 1, "reads": 10, "pairs": 35, "scour_overflow_rows": 1}


def span(name, t0, t1, thread=1, counts=None):
    return (name, thread, t0, t1, counts)


def one_thread(thread=1, at=0):
    return [span("burst.batch", at, at + 100, thread, COUNTS),
            span("burst.prep", at + 10, at + 20, thread),
            span("burst.scour", at + 30, at + 70, thread),
            span("burst.scour.words", at + 35, at + 45, thread),
            span("burst.wait", at + 50, at + 60, thread),
            span("burst.report", at + 80, at + 90, thread),
            # outside any batch: not the program's batch work
            span("burst.prep", at + 200, at + 210, thread)]


def test_self_time_of_nested_and_sibling_spans():
    red = spans.reduce(one_thread())
    assert red.count == {"burst.batch": 1, "burst.prep": 1,
                         "burst.scour": 1, "burst.scour.words": 1,
                         "burst.wait": 1, "burst.report": 1}
    assert red.self_s == pytest.approx({
        "burst.batch": 40e-9, "burst.prep": 10e-9, "burst.scour": 20e-9,
        "burst.scour.words": 10e-9, "burst.wait": 10e-9,
        "burst.report": 10e-9})
    assert red.dur_s["burst.scour"] == pytest.approx(40e-9)
    assert red.batch_spans_max == 6
    assert red.counts == COUNTS
    # no batch span: nothing to reduce
    assert spans.reduce([span("burst.prep", 0, 5)]) is None


def test_two_batch_threads_at_once():
    # two batches overlapping in time, each on its own thread, in the
    # order their spans ended
    kept = sorted(one_thread(1, 0) + one_thread(2, 30), key=lambda k: k[3])
    red = spans.reduce(kept)
    assert red.count["burst.batch"] == 2 and red.batch_spans_max == 6
    assert red.self_s["burst.batch"] == pytest.approx(80e-9)
    assert red.self_s["burst.scour"] == pytest.approx(40e-9)
    assert red.counts == {k: 2 * v for k, v in COUNTS.items()}


def _run(trace=True):
    return types.SimpleNamespace(trace=object() if trace else None,
                                 traced_reads=20)


def test_spans_taken_from_the_program_once(monkeypatch, capsys):
    kept = [one_thread(1, 0) + one_thread(2, 30)]
    prog = types.SimpleNamespace(take_spans=lambda: kept.pop() if kept
                                 else [])
    monkeypatch.setitem(sys.modules, spans.PROGRAM, prog)
    run = _run()
    red = spans.of(run)
    assert red.count["burst.batch"] == 2 and run.spans is red
    assert spans.of(run) is red                 # taken once, kept
    assert spans.self_ms_per_kread(run, "burst.scour") == \
        pytest.approx(1e6 * 40e-9 / 20)
    assert spans.self_ms_per_kread(run, "burst.select") is None
    assert "[bench] spans: 2 batches (20 reads counted, 20 traced)" in \
        capsys.readouterr().err
    # an untraced run reads nothing
    assert spans.of(_run(trace=False)) is None


def test_nothing_read_from_a_program_without_spans(monkeypatch):
    # the parent's `devtime`: no kept spans
    monkeypatch.setitem(sys.modules, spans.PROGRAM, types.SimpleNamespace())
    assert spans.of(_run()) is None
    monkeypatch.delitem(sys.modules, spans.PROGRAM)
    assert spans.self_ms_per_kread(_run(), "burst.scour") is None


def _bench_run():
    spec = importlib.util.spec_from_file_location(
        "bench_run_tests", os.path.join(BENCH, "tests", "test_bench_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_listed(tmp_path_factory):
    """The run tests' copy with its tiny cells, the new metrics listing
    them too."""
    br = _bench_run()
    tmp = br._checkout(tmp_path_factory.mktemp("checkout"))
    br._add_tiny_cells(tmp)
    man = json.loads((tmp / "BENCHMARK.json").read_text())
    for m in man["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = m["workloads"] + list(br.TINY_CELLS)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return br, tmp


@pytest.mark.parametrize("cell", ["tiny.best", "tiny.cap"])
def test_new_readers_on_the_cpu(tiny_listed, cell):
    br, tmp = tiny_listed
    p, out = br._run(tmp, "--workload", cell, "--trace", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    assert out["correct"] is True
    got = out["metrics"]
    # every span and counter reader reads something
    for name in NEW:
        assert got[name]["value"] >= 0, name
    assert got["pairs_per_read"]["value"] > 0
    assert got["scour_host_ms_per_kread"]["value"] > 0
    assert "[bench] spans: " in p.stderr
    assert p.stderr.strip().splitlines()[-1].startswith("correct:")


def test_manifest_lists_each_new_reader():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        man = json.load(f)
    mine = {m["name"]: m for m in man["per_layer"] if m["name"] in NEW}
    assert set(mine) == set(NEW)
    for m in mine.values():
        assert m["moves"] == "reads_per_s"
        assert m["source"] in ("program_span", "program_counter")
