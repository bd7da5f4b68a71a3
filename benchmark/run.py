"""Run one cell of the benchmark of `burst_tpu_torch` on the card.

    python3 benchmark/run.py --workload amplicon.best292 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. The cell is found by name in
`BENCHMARK.json`: its configuration's file, its traffic in
`benchmark/traffic/<traffic>.json`, each metric's reader in
`benchmark/metrics/<metric>.py` (a function `read(run)` that returns a
number, or None where it finds nothing to read). `--trace 0` prints the
cell's end-to-end metrics, `--trace 1` its per-layer metrics from a run
under torch.profiler. The last line of standard output is one JSON
object; the numbers that decided `correct` end standard error and that
object.

Set-up (counted in `setup_s`, from the first line of this file to the
window's start): the database from its cache under `build/bench_db/`
(built there by the first run in a checkout), `Aligner.from_artifacts`,
the cell's reads drawn from `--seed`, and two warm-up batches of the
cell's own traffic. After the window: the peak memory, then the program
freed, then the plain reference (`harness/reference.py`) on a sample of
the window's reads.

Options for the benchmark's own tests, never given by a check:
`--device cpu` runs without a card (the kernels' plain versions),
`--control 1` judges the control's rows in the program's place (and
prints the program's own reading beside it), and
`--fault drop_half|alter` breaks the program's output underneath."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "burst_tpu")
WARM_BATCH = 1 << 40            # batch indices of the warm-up stream


def fail(msg: str, code: int = 2):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def guard_imports(when: str):
    """Fails if the process holds JAX or the JAX package, by whole
    top-level module name (`burst_tpu_torch` is not `burst_tpu`)."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        fail(f"{when}: the process imported {found}", 3)


def load_manifest(workload: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    cell = next((w for w in man["workloads"] if w["name"] == workload), None)
    if cell is None:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    return man, cell, conf


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports in this mode: end-to-end ones that
    name it (or name no cells), per-layer ones that name it (or name no
    cells and move an end-to-end metric it reports)."""
    name = cell["name"]
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in mine
                             else [])]


def broken(align_batch, fault: str):
    """`align_batch` with its output broken (the tests' faults)."""
    def run(*a, **kw):
        rows = align_batch(*a, **kw).split(b"\n")
        if fault == "drop_half":
            rows = rows[::2]
        elif fault == "alter":
            rows = [r.replace(b"\t1\t", b"\t2\t", 1) for r in rows]
        return b"\n".join(rows)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=("drop_half", "alter"))
    a = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("BURST_TPU_")]:
        del os.environ[k]
    man, cell, conf = load_manifest(a.workload)
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    readers = {m["name"]: metric_reader(m["name"])
               for m in cell_metrics(man, cell, bool(a.trace))}

    import torch
    on_card = a.device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["chips"]):
        fail(f"the cell needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " found")
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    from harness import dbcache, devtrace, gen, judge, window
    from harness.reference import Reference
    from burst_tpu_torch.serving import Aligner

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- set-up
    refs = gen.ref_codes(cfg)
    db_dir = dbcache.ensure(
        ROOT, os.path.join(ROOT, conf["file"]), cfg, refs,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    tax = os.path.join(db_dir, "tax.tsv") \
        if traffic["mode"] == "CAPITALIST" else None
    al = Aligner.from_artifacts(
        os.path.join(db_dir, "db.edx"), os.path.join(db_dir, "db.acx"), tax,
        thres=cfg["thres"], mode=traffic["mode"], do_rc=True,
        taxacut=traffic["taxacut"], device=a.device)
    t_db = time.perf_counter()
    if a.fault:
        al.align_batch = broken(al.align_batch, a.fault)
    batches = gen.Batches(refs, traffic, a.seed)
    batches.prefetch(traffic["prefetch_batches"])
    warm = gen.Batches(refs, traffic, a.seed)
    for _ in al.align_stream((warm[WARM_BATCH + j] for j in range(2)),
                             depth=traffic["depth"]):
        pass
    del warm
    sync()
    print(f"[bench] set-up: database ready and loaded at "
          f"{t_db - T_START:.1f} s, reads drawn and warm-up "
          f"{time.perf_counter() - t_db:.1f} s", file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # -- the window
    prof = None
    if a.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:        # every thread's operations, where torch offers it
            kw = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except TypeError:
            kw = {}
        prof = torch.profiler.profile(activities=acts, **kw)
        prof.start()
    setup_s = time.perf_counter() - T_START
    t0_ns = time.time_ns()
    win = window.run(al, batches, a.seconds, traffic["depth"],
                     drain=bool(a.trace))
    sync()
    t1_ns = time.time_ns()
    # batches past the prefetch were drawn on the feeding thread, inside
    # the window
    late = max(0, len(batches.got) - traffic["prefetch_batches"])
    trace = None
    if prof is not None:
        prof.stop()
        trace = devtrace.reduce(devtrace.profiler_events(prof), t0_ns, t1_ns)
        del prof
    close = win.close(a.seconds)
    if close is None:
        fail(f"the stream ended before {a.seconds} s")
    peak_win = torch.cuda.max_memory_allocated() if on_card else 0
    guard_imports("after the window")

    # -- the check, with the program freed
    counted = win.counted(a.seconds)
    outputs = {k: win.outputs[k] for k in (d.k for d in counted)}
    del al
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    heads = gen.ref_heads(cfg)
    lin = [gen.lineage(cfg, i) for i in range(len(heads))] \
        if traffic["mode"] == "CAPITALIST" else None
    ref = Reference(refs, cfg, heads, lin, a.device)
    picks = judge.sample(gen.batch_rng(a.seed, 1 << 41), sorted(outputs),
                         traffic["batch_reads"], traffic,
                         traffic["check_reads"])
    t_check = time.perf_counter()
    got = judge.judge(ref, traffic, batches, outputs, picks)
    checks = {"rows_wrong": {"value": got["rows_wrong"], "limit": 0},
              "reads_checked": {"value": got["reads_checked"]}}
    if a.control:
        # the control in the program's place decides; the program's own
        # reading of the same reads stands beside it
        ctl = judge.judge(ref, traffic, batches, outputs, picks,
                          control=True)
        checks = {"rows_wrong": {"value": ctl["rows_wrong"], "limit": 0},
                  "reads_checked": checks["reads_checked"],
                  "program_rows_wrong": {"value": got["rows_wrong"]}}
        got = ctl
    check_s = time.perf_counter() - t_check
    del ref
    correct = checks["rows_wrong"]["value"] <= checks["rows_wrong"]["limit"]

    run = types.SimpleNamespace(
        seconds=a.seconds, setup_s=setup_s, window=win, trace=trace,
        peak_window_bytes=peak_win,
        traced_reads=sum(d.reads for d in win.done))
    metrics = {}
    for m in cell_metrics(man, cell, bool(a.trace)):
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": max(setup_peak, peak_win)}
    out = {"correct": bool(correct),
           "attempted": sum(d.reads for d in counted), "failed": 0,
           "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.device_ops,
                            "idle_gaps": trace.idle_gaps}
    out["checks"] = checks
    for line in got["detail"]:
        print(f"[bench] differs: {line}", file=sys.stderr)
    print(f"[bench] window {close.done - win.t0:.3f} s, {len(counted)} "
          f"batches, batch seconds median "
          f"{statistics.median(d.done - d.submit for d in counted):.3f}, "
          f"{late} drawn inside the window; "
          f"reference check {check_s:.1f} s", file=sys.stderr)
    guard_imports("at the end")
    print(f"correct: rows_wrong {got['rows_wrong']} (limit 0) of "
          f"{got['reads_checked']} reads checked", file=sys.stderr,
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
