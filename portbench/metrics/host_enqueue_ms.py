"""host_enqueue_ms: per swap, the host's ms from the call of
HairFast.swap_tensor until it returns (before the result is waited for);
the median over the swaps outside the profiled sub-window."""

from portbench.metrics._common import per_transfer, percentile


def spans(suffix):
    return ["host_enqueue"]


def read(suffix, run):
    return percentile(per_transfer(run, "host_enqueue", lambda c: (c.t1 - c.t0) * 1e3), 50)
