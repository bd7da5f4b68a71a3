"""The program's own layer spans and batch counts in a traced run.

`burst_tpu_torch.devtime.span` keeps every `burst.*` span that the port
opens at its layer boundaries while a torch profiler records: its name,
the system id of the thread that ran it, and its ends on the profiler's
clock (`time.time_ns()`); a `burst.batch` span also carries its batch's
counts (`serving.COUNTERS`). The profiler records only over the traced
window, so the kept spans are the window's. The port adds nothing to
the profiler's own trace, so `devtrace.reduce` reads the same events as
on a program without spans.

`of` takes the kept spans once a run (`devtime.take_spans`) and reduces
them, on every thread that ran a batch, from the start of each
`burst.batch` span to its end:

- each span's self time: its duration less the part its child spans
  cover;
- the counts of the `burst.batch` spans, summed.

Its readers return None where the program keeps no spans."""
from __future__ import annotations

import collections
import dataclasses
import sys

BATCH = "burst.batch"
WAIT = "burst.wait"
PROGRAM = "burst_tpu_torch.devtime"


@dataclasses.dataclass
class Spans:
    count: dict[str, int]            # spans opened, by name
    dur_s: dict[str, float]          # summed durations, by name
    self_s: dict[str, float]         # summed self times, by name
    counts: dict[str, int]           # the batches' counts, summed
    batch_spans_max: int             # the most spans one batch opened

    @staticmethod
    def per_kread(seconds: float, reads: int) -> float | None:
        """Milliseconds per 1,000 reads."""
        return 1e6 * seconds / reads if reads else None


def _tree(spans: list) -> list:
    """One thread's spans (start, end, name, counts) nested: [start,
    end, name, counts, parent index], parents first, each clamped into
    its parent."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack = [], []
    for s, e, n, c in spans:
        while stack and out[stack[-1]][1] <= s:
            stack.pop()
        parent = stack[-1] if stack else -1
        if parent >= 0:
            e = min(e, out[parent][1])
        stack.append(len(out))
        out.append([s, e, n, c, parent])
    return out


def reduce(kept) -> Spans | None:
    """`kept`: the program's spans (name, thread, start_ns, end_ns,
    counts), as `devtime.take_spans` gives them; None without a batch."""
    by_thread = collections.defaultdict(list)
    for name, thread, s, e, counts in kept:
        by_thread[thread].append((s, e, name, counts))
    count = collections.Counter()
    dur = collections.defaultdict(float)
    self_ = collections.defaultdict(float)
    counts = collections.Counter()
    spans_max = 0
    for raw in by_thread.values():
        tree = _tree(raw)
        root, kids = [], [0] * len(tree)
        for i, (s, e, n, c, p) in enumerate(tree):
            root.append(i if p < 0 else root[p])
            if p >= 0:
                kids[p] += e - s
        per_root = collections.Counter()
        for i, (s, e, n, c, p) in enumerate(tree):
            if tree[root[i]][2] != BATCH:
                continue
            count[n] += 1
            dur[n] += (e - s) / 1e9
            self_[n] += (e - s - kids[i]) / 1e9
            per_root[root[i]] += 1
            if p < 0 and c:
                counts.update(c)
        spans_max = max([spans_max, *per_root.values()])
    if not count[BATCH]:
        return None
    return Spans(count=dict(count), dur_s=dict(dur), self_s=dict(self_),
                 counts=dict(counts), batch_spans_max=spans_max)


def of(run) -> Spans | None:
    """The traced run's reduction, taken from the program once and kept
    on `run` (and written on standard error), or None."""
    if run.trace is None:
        return None
    if not hasattr(run, "spans"):
        take = getattr(sys.modules.get(PROGRAM), "take_spans", None)
        run.spans = reduce(take()) if take is not None else None
        report(run.spans, run.traced_reads)
    return run.spans


def self_ms_per_kread(run, name: str) -> float | None:
    red = of(run)
    if red is None or name not in red.count:
        return None
    return red.per_kread(red.self_s[name], run.traced_reads)


def report(red: Spans | None, reads: int):
    """Each span's count, self time and duration per 1,000 reads, and
    how much of the batches' time no child span covers."""
    def say(msg):
        print(f"[bench] spans: {msg}", file=sys.stderr)
    if red is None:
        say("none kept by the program")
        return
    say(f"{red.count[BATCH]} batches ({red.counts.get('reads', 0)} reads "
        f"counted, {reads} traced), at most {red.batch_spans_max} spans a "
        f"batch; burst.batch's own self time "
        f"{100 * red.self_s[BATCH] / max(red.dur_s[BATCH], 1e-12):.2f} % "
        f"of its duration")
    for k in sorted(red.count):
        say(f"{k}: {red.count[k]} spans, self "
            f"{red.per_kread(red.self_s[k], reads) or 0:.3f}, duration "
            f"{red.per_kread(red.dur_s[k], reads) or 0:.3f} ms per 1,000 "
            "reads")
