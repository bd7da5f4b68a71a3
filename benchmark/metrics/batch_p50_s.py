"""Median seconds of a batch from the stream taking it to its bytes, on
the host clock, over every batch of the traced window."""
import statistics


def read(run):
    if run.trace is None or not run.window.done:
        return None
    return statistics.median(d.done - d.submit for d in run.window.done)
