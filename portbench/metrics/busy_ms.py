"""busy_ms.<part>.<cells>: per transfer, the device ms of the profiled
sub-window's operations whose runtime launch lies in the program's span of
that part, the innermost one winning.

  stages  embed, align, shape, blend (the sequential path's shape module
          inside align counts to shape; shape_module_pair is a shape span)
  models  generator, e4e, fse, bisenet, sean, shape_adaptor, rotate,
          blending, post_process (model spans do not nest)
  glue    launched in `serve` but in no model span: resizes, masks,
          dilate/erode, mixing, quantize
"""

from portbench.metrics._program import kept, launched_ns, timeline

STAGES = ("embed", "align", "shape", "blend")
MODELS = ("generator", "e4e", "fse", "bisenet", "sean", "shape_adaptor", "rotate", "blending",
          "post_process")


def read(suffix, run):
    part = suffix.split(".")[0]
    if part in STAGES:
        names, name = STAGES, part
    elif part in MODELS or part == "glue":
        names, name = MODELS + ("serve",), "serve" if part == "glue" else part
    else:
        return None
    got = kept(run)
    if got is None:
        return None
    p, spans = got
    return launched_ns(p, timeline(spans, names, *p.window), name) / 1e6 / p.transfers
