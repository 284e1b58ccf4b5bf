"""The port's zoo file (counterpart of hairfastgan_tpu/params/checkpoint.py,
whose orbax checkpoint is the JAX package's fast path): the port-layout f32
tree in one `torch.save` file, `<checkpoint dir>/zoo_torch.pt`, written by
`python -m hairfastgan_torch.convert_checkpoints` and read back memory-mapped
straight onto the device. Python values of the tree (strides, layer tables)
are stored as they are, so the file loads with `weights_only=True`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

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
