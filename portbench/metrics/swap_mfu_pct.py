"""swap_mfu_pct: the configuration's FLOPs per transfer (counted on the
plain reference, portbench/flops.py) x the transfers of the traced run
outside the profiled sub-window, over those requests' seconds, as a share of
the H100's dense bf16 peak (989 TFLOP/s at 700 W; the card's power limit is
printed beside the result)."""

from portbench.peaks import BF16_FLOPS_PER_S


def read(suffix, run):
    reqs = [r for r in run.requests if r.get("ok") and not r.get("profiled")]
    secs = sum(r["t1"] - r["t0"] for r in reqs)
    n = sum(r["transfers"] for r in reqs)
    if secs <= 0 or n == 0:
        return None
    return 100.0 * run.config["flops_per_transfer"] * n / secs / BF16_FLOPS_PER_S
