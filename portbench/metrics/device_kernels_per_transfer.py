"""device_kernels_per_transfer: CUDA kernels in the profiled sub-window over
the transfers in it."""


def read(suffix, run):
    p = run.tracer.profile if run.tracer is not None else None
    if p is None or p.transfers <= 0 or not p.kernels():
        return None
    return len(p.kernels()) / p.transfers
