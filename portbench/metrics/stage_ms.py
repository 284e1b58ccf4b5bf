"""stage_ms.<span>: per transfer, the device ms between CUDA events recorded
around the span's calls (portbench/spans/<span>.json); the median over the
transfers outside the profiled sub-window."""

from portbench.metrics._common import per_transfer, percentile


def spans(suffix):
    return [suffix]


def read(suffix, run):
    return percentile(per_transfer(run, suffix, lambda c: c.device_ms), 50)
