"""swap_ms_p50: the median of the window's requests, each timed by the host
clock from the call until its uint8 result is on the host."""

from portbench.metrics._common import percentile


def read(suffix, run):
    return percentile(run.latencies_ms(), 50)
