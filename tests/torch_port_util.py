"""Shared helpers of the PyTorch-port tests (tests/test_torch_port_*.py)."""

import jax
import numpy as np

# Tolerance of the model and stage parities: 2e-4 of the reference's largest
# magnitude (reasons in tests/test_torch_port_models.py)
REL = 2e-4


def close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"max err {err} > {rel} * {scale}"


def graft_triples(size: int):
    """The 8 (face, shape, color) [0,1] image triples that
    __graft_entry__._pipeline_setup draws from PRNGKey(2), as numpy."""
    kf, ks, kc = jax.random.split(jax.random.PRNGKey(2), 3)
    return [np.array(jax.random.uniform(k, (8, size, size, 3))) for k in (kf, ks, kc)]


def lively(tree):
    """Shift every norm gamma and every StyleGAN modulation bias of a
    numpy-filled JAX zoo by +1 (their real initial values). With the flat
    0.05 fill each BatchNorm scales its map by ~0.05, so deep outputs
    collapse onto the last biases and a wrong layer upstream would hide
    under a tolerance; shifted, signals carry through every model."""
    def shift(path, v):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] == "gamma" or (keys[-1] == "b" and "modulation" in keys):
            return v + np.float32(1.0)
        return v

    return jax.tree_util.tree_map_with_path(shift, tree)
