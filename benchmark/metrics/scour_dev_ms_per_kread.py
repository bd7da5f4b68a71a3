"""Device milliseconds per 1,000 reads of every kernel that is not one of
the program's hand-written kernels (the scour's PyTorch operations,
gathers and sorts around the kernels), over the traced window."""
from harness.devtrace import is_hand


def read(run):
    if run.trace is None or not run.traced_reads:
        return None
    ms = 1e3 * run.trace.kernel_s(lambda k: not is_hand(k))
    return ms / (run.traced_reads / 1e3) if ms > 0 else None
