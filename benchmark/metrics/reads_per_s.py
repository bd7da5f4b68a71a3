"""Reads of the batches completed in the window over the seconds from its
start to the last of them (reads with an N and reads under k count)."""


def read(run):
    if run.trace is not None:
        return None
    return run.window.reads_per_s(run.seconds)
