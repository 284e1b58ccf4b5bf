"""generator_device_ms: device ms per transfer of the kernels launched inside
the generator's calls (the `generator` span), in the profiled sub-window."""


def spans(suffix):
    return ["generator"]


def read(suffix, run):
    p = run.tracer.profile if run.tracer is not None else None
    if p is None or p.transfers <= 0:
        return None
    ks = p.launched_in("generator")
    if not ks:
        return None
    return sum(e - s for _, _, s, e, _ in ks) / 1e6 / p.transfers
