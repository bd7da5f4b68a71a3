"""Duration of the program's `burst.wait` spans (`devtime.fetch`,
`Fetch.wait`, the staging ring's blocked wait) per 1,000 reads: the time
the batches' host work waited for the device, summed over every batch
thread of the traced window."""
from harness import spans


def read(run):
    red = spans.of(run)
    if red is None or spans.WAIT not in red.count:
        return None
    return red.per_kread(red.dur_s[spans.WAIT], run.traced_reads)
