"""The port's layer spans (`devtime.span`) and batch counters
(`Aligner.counters`), on the CPU with the kernels' plain versions:

  (a) under a torch profiler one two-step CAPITALIST batch and one
      fused BEST batch each keep `burst.batch` once, with every layer
      span nested inside it on the same thread, its batch's counts on
      it, the same bytes as without the profiler, and nothing of the
      program's in the profiler's own trace;
  (b) two batches through `align_stream(depth=2)` under a profiler of
      every thread give two `burst.batch` spans, each holding only its
      own thread's spans; the counters then grow by the sequential
      batches' totals;
  (c) without a profiler `devtime.span` is one shared null context and
      keeps nothing;
  (d) `Aligner.counters` after sequential batches is the sum of their
      `last_stats`, also under many threads at once;
  (e) `devtime.track()` counts only its own thread's fetches;
  (f) the CLI under `BURST_TPU_PROFILE` writes its spans."""
import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from burst_tpu_torch import devtime
from burst_tpu_torch.accel import build_accelerator
from burst_tpu_torch.process import process_references
from burst_tpu_torch.serving import COUNTERS, Aligner, _batch_counts

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
THRES = 0.98
LAYERS = {"burst.prep", "burst.scour", "burst.scour.words", "burst.pairs",
          "burst.select", "burst.rescore", "burst.report", "burst.wait"}


def _refs():
    """Ten families of three 120 bp members at 5 % from their ancestor."""
    rng = np.random.default_rng(19)
    refs, heads = [], []
    for f in range(10):
        anc = rng.choice(BASES, size=120)
        for m in range(3):
            r = anc.copy()
            pos = rng.integers(0, 120, 6)
            r[pos] = BASES[rng.integers(0, 4, 6)]
            refs.append(r)
            heads.append(b"f%03dm%02d" % (f, m))
    return heads, refs


def _batch(refs, seed):
    """140 reads of 60 bp (280 unibins with both strands: QBUNCH 2),
    every 37th with an N, every 61st cut to 9 bp (a full-scan row)."""
    rng = np.random.default_rng(seed)
    heads, reads = [], []
    for i in range(140):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, len(s) - 60))
        r = s[st:st + 60].copy()
        if i % 37 == 0:
            r[int(rng.integers(0, 60))] = ord("N")
        if i % 61 == 3:
            r = r[:9].copy()
        reads.append(r)
        heads.append(b"q%d_%04d" % (seed, i))
    return heads, reads


@pytest.fixture(scope="module", autouse=True)
def _small_chunks():
    # scour chunks the size of this workload, not of a card's
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BURST_TPU_SCOUR_CHUNK", "1024")
        mp.setenv("BURST_TPU_SCOUR_BCHUNK", "64")
        yield


@pytest.fixture(scope="module")
def work():
    heads, refs = _refs()
    rd = process_references(heads, [r.copy() for r in refs], max_len_q=60,
                            thres=THRES, rebase=True, rebase_amt=320,
                            curate=2)
    acc = build_accelerator(rd, k=10, z=1)
    batches = [_batch(refs, 1), _batch(refs, 2)]
    out = {}
    for mode in ("CAPITALIST", "BEST"):
        al = Aligner(rd, acc, thres=THRES, mode=mode, do_rc=True,
                     device="cpu")
        got = []
        for b in batches[:2 if mode == "CAPITALIST" else 1]:
            got.append((al.align_batch(*b), dict(al.last_stats)))
        out[mode] = (al, got, al.counters)
    return batches, out


def _spans():
    """(name, thread, start, end) of the spans the program kept."""
    return [k[:4] for k in devtime.take_spans()]


def _in_trace(prof) -> list:
    """The profiler's own events of the program's span names."""
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("burst.")]


def _all_threads():
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=cfg)


@pytest.mark.parametrize("mode,path_key", [("CAPITALIST", "bunch_ov_rows"),
                                           ("BEST", "dev_pairs")])
def test_one_batch_spans_nest_inside_burst_batch(work, mode, path_key):
    batches, out = work
    al, got, _ = out[mode]
    # the two-step path (its bunch scour) and the fused scan
    assert path_key in got[0][1]
    devtime.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b6 = al.align_batch(*batches[0])
    assert b6 == got[0][0]
    kept = devtime.take_spans()
    sp = [k[:4] for k in kept]
    top = [s for s in sp if s[0] == "burst.batch"]
    assert len(top) == 1
    # the batch span carries the batch's counts; the trace holds none
    assert [k.counts for k in kept if k.name == "burst.batch"] == \
        [_batch_counts(got[0][1], len(batches[0][0]))]
    assert _in_trace(prof) == []
    _, tid, t0, t1 = top[0]
    inner = [s for s in sp if s[0] != "burst.batch"]
    assert {s[0] for s in inner} == LAYERS
    assert all(s[1] == tid and t0 <= s[2] <= s[3] <= t1 for s in inner)
    # no span per read or pair: a handful a layer
    assert len(sp) <= 64


def test_stream_batches_hold_only_their_own_spans(work):
    batches, out = work
    al, got, _ = out["CAPITALIST"]
    before = al.counters
    devtime.take_spans()
    with _all_threads():
        b6 = list(al.align_stream(batches, depth=2))
    assert b6 == [g[0] for g in got]
    sp = _spans()
    top = [s for s in sp if s[0] == "burst.batch"]
    assert len(top) == 2
    for name, tid, s0, s1 in sp:
        if name == "burst.batch":
            continue
        mine = [t for t in top if t[1] == tid and t[2] <= s0 <= s1 <= t[3]]
        assert len(mine) == 1, (name, tid)
    for t in top:
        held = {s[0] for s in sp if s[1] == t[1] and t[2] <= s[2] < t[3]
                and s[0] != "burst.batch"}
        assert held == LAYERS
    # concurrent batches add up to the sequential ones' totals
    after = al.counters
    seq = _expected([g[1] for g in got], [len(b[0]) for b in batches])
    assert {k: after[k] - before[k] for k in COUNTERS} == seq


def test_span_without_a_profiler_is_one_null_context():
    a = devtime.span("burst.batch")
    with a:
        pass
    assert a is devtime.span("burst.scour")
    assert isinstance(a, contextlib.nullcontext)
    devtime.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        on = devtime.span("burst.scour")
        with on:
            pass
    with devtime.span("burst.prep"):
        pass
    assert not isinstance(on, contextlib.nullcontext)
    # only the span opened while the profiler ran
    assert [s[0] for s in _spans()] == ["burst.scour"]
    assert devtime.take_spans() == []


def _expected(stats: list, reads: list) -> dict:
    """The counters a run of batches with these `last_stats` gives."""
    tot = dict.fromkeys(COUNTERS, 0)
    for st, n in zip(stats, reads):
        tot["batches"] += 1
        tot["reads"] += n
        if "dev_pairs" in st:                   # the fused scan
            tot["pairs"] += st["dev_pairs"] + st["side_pairs"]
            tot["scour_overflow_rows"] += st["ov_rows"]
        else:                                   # the two-step path
            tot["pairs"] += st["pairs"]
            tot["scour_overflow_rows"] += st["bunch_ov_rows"] \
                + st["member_ov_rows"]
    return tot


@pytest.mark.parametrize("mode", ["CAPITALIST", "BEST"])
def test_counters_sum_the_sequential_batches(work, mode):
    batches, out = work
    _, got, counted = out[mode]
    # the fixture's batches, the first on this Aligner, one after another
    n = len(got)
    want = _expected([g[1] for g in got], [len(b[0]) for b in batches[:n]])
    assert want["pairs"] > 0 and all(g[1]["full_rows"] > 0 for g in got)
    assert counted == want


def test_counters_lose_no_update_under_threads(work):
    _, out = work
    al = out["BEST"][0]
    before = al.counters
    one = {"batches": 1, "reads": 3, "pairs": 5, "scour_overflow_rows": 1}
    nthreads, each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [al._count(one)
                                               for _ in range(each)])
              for _ in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    after = al.counters
    assert {k: after[k] - before[k] for k in COUNTERS} == \
        {k: v * nthreads * each for k, v in one.items()}


def test_track_counts_only_its_own_threads_fetches():
    barrier = threading.Barrier(2)
    got = {}

    def run(name, n):
        with devtime.track() as acc:
            barrier.wait(timeout=30)
            for _ in range(n):
                devtime.fetch(torch.zeros(3))
            devtime.Fetch([torch.ones(2)]).wait()
            barrier.wait(timeout=30)
            got[name] = dict(acc)

    ts = [threading.Thread(target=run, args=("a", 3)),
          threading.Thread(target=run, args=("b", 11))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert got["a"]["n"] == 4 and got["b"]["n"] == 12
    assert set(got["a"]) == {"s", "n", "up_s"}
    # no scope on this thread: nothing counted here
    devtime.fetch(torch.zeros(1))
    with devtime.track() as acc:
        pass
    assert acc["n"] == 0


def test_cli_profile_writes_its_spans(tmp_path, monkeypatch):
    from burst_tpu_torch import cli
    heads, refs = _refs()
    qh, reads = _batch(refs, 3)
    for name, hs, ss in (("refs.fa", heads, refs), ("reads.fa", qh, reads)):
        (tmp_path / name).write_bytes(b"".join(
            b">%s\n%s\n" % (h, bytes(s)) for h, s in zip(hs, ss)))
    monkeypatch.setenv("BURST_TPU_PROFILE", str(tmp_path / "prof"))
    devtime.take_spans()
    rc = cli.main(["burst", "-r", str(tmp_path / "refs.fa"), "-q",
                   str(tmp_path / "reads.fa"), "-o", str(tmp_path / "o.b6"),
                   "-m", "BEST", "--noprogress"], device="cpu")
    assert rc == 0
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    names = [s["name"] for s in got]
    # the direct path: its prep and its streamed scan inside the batch
    assert names.count("burst.batch") == 1
    assert {"burst.prep", "burst.pairs"} <= set(names)
    batch = got[names.index("burst.batch")]
    assert any(s["name"] == "burst.pairs"
               and batch["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= batch["end_ns"] for s in got)
    assert devtime.take_spans() == []
