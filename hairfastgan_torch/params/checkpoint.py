"""The port's zoo file (counterpart of hairfastgan_tpu/params/checkpoint.py,
whose orbax checkpoint is the JAX package's fast path): the port-layout f32
tree in one `torch.save` file, `<checkpoint dir>/zoo_torch.pt`, written by
`python -m hairfastgan_torch.convert_checkpoints` and read back memory-mapped
straight onto the device. Python values of the tree (strides, layer tables)
are stored as they are, so the file loads with `weights_only=True`.

The trainers' state (trained params, the optimizer's state_dict, the step)
goes the same way into `<dir>/train_state.pt` (save_train_state).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Sequence

import torch

from hairfastgan_torch.params.bridge import map_tree

ZOO_FILE = "zoo_torch.pt"


def save_zoo(checkpoint_dir, zoo: Dict) -> Path:
    """Write `zoo` (float leaves as f32, on the CPU) to
    `checkpoint_dir`/zoo_torch.pt; returns the file's path."""
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / ZOO_FILE
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    host = map_tree(zoo, lambda _, t: (t.float() if t.is_floating_point() else t).cpu())
    torch.save(host, tmp)
    os.replace(tmp, path)  # readers never see a partial file
    return path


def load_zoo_file(path, device="cpu") -> Dict:
    """A file of `save_zoo` -> the zoo on `device`, read memory-mapped."""
    return torch.load(str(path), map_location=torch.device(device), weights_only=True,
                      mmap=True)


TRAIN_STATE_FILE = "train_state.pt"


def save_train_state(path, params: Any, opt_state: Dict, step: int, disc_params: Any = None,
                     strip: Sequence[str] = ("clip",)) -> Path:
    """Training checkpoint incl. optimizer + step (counterpart of the JAX
    package's save_train_state): `params` without the frozen subtrees named
    in `strip` (the CLIP tower rides in the blending tree), the optimizer's
    `state_dict()`, `step` and, when given, the PostProcess trainer's
    discriminator under "disc" (pp_train.py:100-112; its Adam state is not
    kept, as in the JAX package), detached on the CPU, in one `torch.save`
    file `<path>/train_state.pt`. Returns the file's path."""
    tree = {"params": ({k: v for k, v in params.items() if k not in strip}
                       if isinstance(params, dict) else params),
            "opt_state": opt_state, "step": step}
    if disc_params is not None:
        tree["disc"] = disc_params
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    out = d / TRAIN_STATE_FILE
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, out)  # readers never see a partial file
    return out


def restore_train_state(path, device="cpu") -> Dict[str, Any]:
    """`<path>/train_state.pt` -> {"params", "opt_state", "step"[, "disc"]}
    with every tensor on `device`; `opt.load_state_dict(state["opt_state"])`
    puts the Adam moments back."""
    return torch.load(str(Path(path) / TRAIN_STATE_FILE), map_location=torch.device(device),
                      weights_only=True)


def _to_host(tree):
    """Detached CPU copies of the tensors of nested dicts, lists and tuples
    (an optimizer's state_dict keys its states by int)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree
