"""Training scaffolding shared by the encoder training loops (counterpart of
hairfastgan_tpu/train/common.py).

The reference trains Rotate/Blending with torch Adam + clip_grad_norm(5) on
one GPU (scripts/*_train.py). Here parameters are the port's plain trees of
tensors: the trained tree's leaves are what the optimizer steps, frozen
trees are tensors with requires_grad=False handed to the loss at call time.
A step is eager autograd: no custom backward exists anywhere on the path.
MovingAverageLoss mirrors rotate_train.py's per-loss EMA scaling.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor


def tensor_leaves(tree) -> List[Tensor]:
    """Tensor leaves of a tree of dicts and lists, dict keys in sorted order
    (the order jax flattens them in); Python values are skipped."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, Tensor) else []


def freeze(tree):
    """Mark every tensor leaf of a frozen tree requires_grad=False; returns it."""
    for t in tensor_leaves(tree):
        t.requires_grad_(False)
    return tree


def global_norm(tensors) -> Tensor:
    """sqrt(sum of squares) over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


@dataclasses.dataclass(frozen=True)
class AdamWithClip:
    """Adam (lr, betas (0.9, 0.999), eps 1e-8) preceded by a global L2 clip,
    as optax.chain(clip_by_global_norm(clip_norm), adam(lr)): every gradient
    becomes g / ||g|| * clip_norm when ||g|| >= clip_norm, with no eps
    (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm and so changes
    the update)."""

    lr: float = 1e-4
    clip_norm: float = 5.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def init(self, params) -> torch.optim.Adam:
        """The optimizer over the tree's leaves, which become trainable
        (requires_grad=True); it steps them in place."""
        leaves = tensor_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=self.lr, betas=self.betas, eps=self.eps)

    def clip_(self, grads: List[Tensor]) -> Tensor:
        """Clip `grads` in place; returns their norm before the clip."""
        norm = global_norm(grads)
        keep = norm < self.clip_norm  # a device scalar: no sync with the host
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        return norm


def adam_with_clip(lr: float = 1e-4, clip_norm: float = 5.0) -> AdamWithClip:
    """Adam + global-norm clip 5 (reference scripts/*_train.py optimizers)."""
    return AdamWithClip(lr=lr, clip_norm=clip_norm)


def apply_update(tx: AdamWithClip, opt: torch.optim.Optimizer) -> Tensor:
    """One update from the gradients in the trainable leaves' `.grad`: a leaf
    the loss did not reach gets a zero gradient (so that Adam moves its
    moments as optax does), the gradients are clipped as optax does, Adam
    steps in place and the gradients are set back to None. Returns the
    gradients' norm before the clip."""
    leaves = [p for group in opt.param_groups for p in group["params"]]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = tx.clip_([p.grad for p in leaves])
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norm


def make_train_step(loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
                    tx: AdamWithClip, remat: bool = False, frozen: Any = None):
    """loss_fn(params, [frozen,] *batch) -> (scalar, aux) => an update step

        params, opt, aux = step(params, opt, *batch)

    where `opt = tx.init(params)`. The step runs the loss, backpropagates
    into the trainable leaves (the optimizer's) and applies the update
    (apply_update). `aux` gains `loss` and `grad_norm` (the norm
    before the clip, optax.global_norm(grads)), detached on the device.

    frozen: the non-trained weights, passed to loss_fn as its second
    positional argument; their leaves are set requires_grad=False, so no
    gradient is computed for them. remat=True runs the loss under
    torch.utils.checkpoint (activations recomputed on the backward pass;
    same gradients). The JAX package's `donate` has no meaning here (the
    step updates the parameters in place) and is not an argument.
    """
    if frozen is not None:
        freeze(frozen)

    def run(params, *args):
        if remat:
            return checkpoint(loss_fn, params, *args, use_reentrant=False)
        return loss_fn(params, *args)

    def step(params, opt: torch.optim.Optimizer, *batch):
        fargs = ((frozen,) if frozen is not None else ()) + batch
        loss, aux = run(params, *fargs)
        loss.backward()
        norm = apply_update(tx, opt)
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach(), grad_norm=norm.detach())
        return params, opt, aux

    return step


class MovingAverageLoss:
    """Host-side EMA loss normalization (rotate_train.py:26-42).

    The reference scales each term by weight_k / EMA_k when composing the
    training loss, with the EMA updated from the PREVIOUS steps' magnitudes
    (`update` runs after backward). `multipliers` returns those per-term
    scalars as Python floats for the step.
    """

    def __init__(self, weights: Dict[str, float], alpha: float = 0.02):
        self.weights_cfg = weights
        self.alpha = alpha
        self.vals: Dict[str, float] = {}

    def update(self, losses: Dict[str, float]) -> None:
        for k, v in losses.items():
            v = float(v)
            self.vals[k] = self.alpha * v + (1 - self.alpha) * self.vals.get(k, v)

    def multipliers(self, keys) -> Tuple[float, ...]:
        return tuple(self.weights_cfg.get(k, 1.0)
                     / max(self.vals.get(k, 1.0), 1e-8) for k in keys)


def check_finite_loss(loss, step: int) -> None:
    """NaN guard: raise instead of training on garbage (the reference's
    shape-branch solver raises on NaN loss, solver.py:151-156)."""
    v = float(loss)
    if not np.isfinite(v):
        raise FloatingPointError(f"non-finite loss {v} at step {step}")


class MetricLogger:
    """Minimal metric logger: running scalars + optional jsonl file (stands
    in for the reference's WandbLogger, utils/train.py:31-63)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.step = 0
        self._file = open(path, "a") if path else None

    def log(self, **scalars):
        self.step += 1
        if self._file:
            self._file.write(json.dumps({"step": self.step, **{
                k: float(v) for k, v in scalars.items()}}) + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
