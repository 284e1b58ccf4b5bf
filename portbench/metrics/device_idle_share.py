"""device_idle_share: 100 x (1 - the union of the device operations'
intervals / the profiled sub-window's length)."""


def read(suffix, run):
    p = run.tracer.profile if run.tracer is not None else None
    if p is None or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_ns() / (p.window[1] - p.window[0]))
