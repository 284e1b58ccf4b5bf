"""dilate_erode_roofline: the least time of the profiled sub-window's
dilate_erode launches (portbench/peaks.dilate_erode_bound at each launch's
shape, item size and iterations, from the `dilate_erode` span's arguments)
over their device time by the profiler, in %."""

from portbench.peaks import dilate_erode_bound


def spans(suffix):
    return ["dilate_erode"]


def read(suffix, run):
    t = run.tracer
    p = t.profile if t is not None else None
    if p is None:
        return None
    calls = [c for c in t.calls if c.name == "dilate_erode" and c.profiled and c.args]
    ks = [k for k in p.kernels() if "dilate_erode" in k[1]]
    if not calls or len(calls) != len(ks):
        return None
    bound = 0.0
    for c in calls:
        (shape, itemsize), iters = c.args[0], (c.args[1] if len(c.args) > 1 else 5)
        bound += dilate_erode_bound(shape, itemsize, iters)[0] * 1e6  # ns
    return 100.0 * bound / sum(e - s for _, _, s, e, _ in ks)
