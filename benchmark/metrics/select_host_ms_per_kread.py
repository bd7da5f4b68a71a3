"""Self time of the program's `burst.select` span (`engine.select_pods`,
`accel_pod_order`, `lookup_cols`) per 1,000 reads: its duration less the
part its child spans cover, summed over every batch thread of the traced
window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.select")
