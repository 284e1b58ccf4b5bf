"""law "lecun": conv and linear weights N(0,1) / sqrt(fan-in) (e4e's
EqualLinear heads N(0,1): they scale at run time), PReLU slopes 0.25, norms
the identity (gamma, var 1; beta, mean 0), biases 0, CLIP's embeddings
N(0,1) / sqrt(width) and its projection N(0,1) / sqrt(fan-in), SEAN's noise
strengths and blend logits 0 (normalization.py: torch.zeros), latent
averages and SEAN's mean codes N(0,1)."""

import math
from typing import Tuple

_ONES, _ZEROS = ("gamma", "var"), ("beta", "mean", "b", "bias", "noise_var", "blend_gamma",
                                   "blend_beta")


def law(path: Tuple[str, ...], shape) -> Tuple[str, float]:
    """(kind, value): kind "normal" scales a N(0,1) view by value, "uniform"
    keeps a U(0,1) view, "const" fills value."""
    key = path[-1]
    if key == "w" and len(shape) == 4:  # conv [O,I,kh,kw]
        return "normal", 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
    if key == "w" and len(shape) == 2:  # linear [out,in]; e4e's EqualLinear scales at run time
        return "normal", 1.0 if path[0] == "e4e" else 1.0 / math.sqrt(shape[1])
    if key == "w" and len(shape) == 1:  # PReLU slopes
        return "const", 0.25
    if key == "proj":  # CLIP's output projection, x @ proj
        return "normal", 1.0 / math.sqrt(shape[0])
    if key in ("class_emb", "pos_emb"):
        return "normal", 1.0 / math.sqrt(shape[-1])
    if key in _ONES:
        return "const", 1.0
    if key in _ZEROS:
        return "const", 0.0
    return "normal", 1.0  # latent averages, SEAN's mean codes
