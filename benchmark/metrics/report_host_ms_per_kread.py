"""Self time of the program's `burst.report` span (`modes.report_*`,
CAPITALIST's LCA among them) per 1,000 reads: its duration less the part
its child spans cover, summed over every batch thread of the traced
window."""
from harness import spans


def read(run):
    return spans.self_ms_per_kread(run, "burst.report")
