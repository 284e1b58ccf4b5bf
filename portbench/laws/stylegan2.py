"""law "stylegan2": every 'w' and the constant 'input' N(0,1) (the equalized
learning rate scales them at run time), modulation biases 1, other biases
and the noise weights 0."""


def law(path, shape):
    if path[-1] in ("w", "input"):
        return "normal", 1.0
    return "const", 1.0 if path[-2:] == ("modulation", "b") else 0.0
