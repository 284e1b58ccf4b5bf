"""law "bisenet": conv weights 0.02 * N(0,1), biases 0, identity BatchNorm."""


def law(path, shape):
    fixed = {"gamma": 1.0, "var": 1.0, "beta": 0.0, "mean": 0.0, "b": 0.0}
    if path[-1] in fixed:
        return "const", fixed[path[-1]]
    return "normal", 0.02
