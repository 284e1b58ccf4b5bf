"""The port's data-generation, training and evaluation CLIs
(`python -m hairfastgan_torch.scripts.<name>`), counterparts of the JAX
package's scripts/, and the pieces they share."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def device_from_arg(name: str) -> torch.device:
    """--device -> torch.device; a CUDA device without a GPU raises (the
    scripts never fall back to the CPU by themselves)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def image_files(d: Path):
    return sorted(p for p in Path(d).iterdir() if p.suffix.lower() in IMAGE_SUFFIXES)


def batches(rows: Sequence[Path], keys: Sequence[str], batch_size: int, device,
            seed: int = 0, shuffle: bool = True) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Batches of .npz rows (each [1,...] per key) concatenated along dim 0,
    on `device`, in an order shuffled by `seed`; the last partial batch is
    dropped (the JAX CLIs' batching)."""
    idx = np.arange(len(rows))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        chunk = []
        for j in idx[i:i + batch_size]:
            with np.load(rows[j]) as z:
                chunk.append({k: z[k] for k in keys})
        yield tuple(torch.from_numpy(np.concatenate([c[k] for c in chunk])).to(device)
                    for k in keys)
