"""Scour rows re-scoured on the host for overflowing the device slot
budget, per 1,000 reads over the traced window, from the counts that the
program's `burst.batch` spans carry (`scour_overflow_rows` over
`reads`): the scour's retries, which a smaller slot margin (and so a
smaller `peak_mem_gib`) would raise."""
from harness import spans


def read(run):
    red = spans.of(run)
    if red is None or not red.counts.get("reads"):
        return None
    return red.counts["scour_overflow_rows"] / (red.counts["reads"] / 1e3)
