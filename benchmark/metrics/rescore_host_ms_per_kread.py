"""Self time of the program's `burst.rescore` span
(`engine.rescore_winners`: K3's planning and dispatch) per 1,000 reads:
its duration less the part its child spans cover, summed over every
batch thread of the traced window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.rescore")
