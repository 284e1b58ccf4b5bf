"""idle_ms.<bucket>.<cells>: per transfer, the ms of the profiled sub-window
in which no device operation ran (the window minus the union of the device
operations), while the host was inside the program's `upload`, `serve` or
`fetch` span (the innermost of them; their children included), or in none
of them (`other`: the rest of the request and the caller). The four buckets
sum to the sub-window's idle time."""

from portbench.metrics._program import idle_gaps, kept, timeline

BUCKETS = ("upload", "serve", "fetch")


def read(suffix, run):
    bucket = suffix.split(".")[0]
    got = kept(run)
    if got is None or bucket not in BUCKETS + ("other",):
        return None
    p, spans = got
    want = None if bucket == "other" else bucket
    segments = timeline(spans, BUCKETS, *p.window)
    ns = 0
    for gs, ge in idle_gaps(p):
        ns += sum(min(ge, e) - max(gs, s) for s, e, name in segments
                  if name == want and s < ge and e > gs)
    return ns / 1e6 / p.transfers
