"""Self time of the program's `burst.pairs` span (pair expansion and the
dispatch of K1/K2 and K4) per 1,000 reads: its duration less the part
its child spans cover, summed over every batch thread of the traced
window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.pairs")
