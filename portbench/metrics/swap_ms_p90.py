"""swap_ms_p90: the 90th percentile (nearest rank) of the window's requests, each timed by the host
clock from the call until its uint8 result is on the host."""

from portbench.metrics._common import percentile


def read(suffix, run):
    return percentile(run.latencies_ms(), 90)
