"""Device milliseconds per 1,000 reads of the rescore K3 (`rescore*`
kernels of csrc/rescore.cu), over the traced window."""


def read(run):
    if run.trace is None or not run.traced_reads:
        return None
    ms = 1e3 * run.trace.kernel_s(lambda k: k.startswith("rescore"))
    return ms / (run.traced_reads / 1e3) if ms > 0 else None
