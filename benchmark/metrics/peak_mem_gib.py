"""torch.cuda.max_memory_allocated() over the window, the database
resident, in GiB: what is left of the card for a larger database."""


def read(run):
    if run.trace is not None or not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
