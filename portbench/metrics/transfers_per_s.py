"""transfers_per_s: the transfers completed in the window over the window's
seconds (from the first call to the last result on the host)."""


def read(suffix, run):
    if run.window_s <= 0:
        return None
    return run.transfers() / run.window_s
