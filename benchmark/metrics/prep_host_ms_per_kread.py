"""Self time of the program's `burst.prep` span (`process.process_queries`,
`bin_queries_for_accel`) per 1,000 reads: its duration less the part its
child spans cover, summed over every batch thread of the traced window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.prep")
