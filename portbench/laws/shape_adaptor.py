"""law "shape_adaptor": conv weights 0.02 * N(0,1), linear weights
N(0,1) / sqrt(fan-in), layer-norm gammas U(0,1), the rest 0."""

import math


def law(path, shape):
    if path[-1] == "w":  # conv [O,I,kh,kw] or linear [out,in]
        return "normal", 0.02 if len(shape) == 4 else 1.0 / math.sqrt(shape[1])
    if path[-1] == "gamma":
        return "uniform", 1.0
    return "const", 0.0
