"""Self time of the program's `burst.scour` span (`engine.accel_candidates`
and the fused scan's scour: dispatch, uploads, the native scour of
ambiguous bunches, visit assembly) per 1,000 reads: its duration less
the part its child spans cover, summed over every batch thread of the
traced window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.scour")
