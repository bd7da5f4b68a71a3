"""Seconds from the process's start to the window's: CUDA start-up, the
database read from its cache onto the card, the reads drawn, the
warm-up batches."""


def read(run):
    if run.trace is not None:
        return None
    return run.setup_s
