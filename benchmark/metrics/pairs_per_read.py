"""(read, unit) pairs scanned by K1/K2 per read over the traced window,
from the counts that the program's `burst.batch` spans carry (`pairs`
over `reads`, as `Aligner.counters` sums them)."""
from harness import spans


def read(run):
    red = spans.of(run)
    if red is None or not red.counts.get("reads"):
        return None
    return red.counts["pairs"] / red.counts["reads"]
