"""Training scaffolding shared by the encoder training loops (counterpart of
hairfastgan_tpu/train/common.py).

The reference trains Rotate/Blending with torch Adam + clip_grad_norm(5) on
one GPU (scripts/*_train.py). Here parameters are the port's plain trees of
tensors: the trained tree's leaves are what the optimizer steps, frozen
trees are tensors with requires_grad=False handed to the loss at call time.
A step is eager autograd: no custom backward exists anywhere on the path.
On a data mesh (parallel/mesh.py) a step shards the batch, runs the loss on
each shard against the device's replica of the parameters, and reduces the
shards' losses into the global batch's before ONE backward: the replicas'
gradients sum into the master parameters, and the clip and Adam run once on
the lead device, as the gradient psum gives them in the JAX package.
MovingAverageLoss mirrors rotate_train.py's per-loss EMA scaling.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from hairfastgan_torch.parallel import mesh

Tensor = torch.Tensor


def tensor_leaves(tree) -> List[Tensor]:
    """Tensor leaves of a tree of dicts and lists, dict keys in sorted order
    (the order jax flattens them in); Python values are skipped; the
    copies of a parallel.mesh.Replicas in mesh order."""
    if isinstance(tree, mesh.Replicas):
        return [t for v in tree.values() for t in tensor_leaves(v)]
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


def shard_loss(plan: mesh.MeshPlan, loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]]):
    """loss_fn(params, *args) -> (scalar, aux) of a batch => the same over
    the global batch on the data mesh `plan`:

        loss, aux = shard_loss(plan, loss_fn)(params, *args)

    `params` is replicated on each distinct device (differentiably: the
    backward pass sums the replicas' gradients into it). Tensor arguments
    are the batch, split over the data devices; a Replicas argument gives
    each shard its device's copy; other dicts and lists are replicated per
    call; anything else (floats, tuples of floats) passes as it is. The
    shards' losses and scalar aux values are summed with weights b_i / B on
    the lead device (parallel.mesh.reduce_shards), which is the global
    value for batch-mean losses; batched aux tensors are concatenated."""
    def run(params, *args):
        reps = mesh.replicate(plan, params)
        shards = [mesh.shard_batch(plan, a) if isinstance(a, Tensor) else None for a in args]
        args = [mesh.replicate(plan, a) if s is None and isinstance(a, (dict, list)) else a
                for a, s in zip(args, shards)]
        results = [loss_fn(mesh.on(reps, d), *(s[i] if s is not None else mesh.on(a, d)
                                                  for a, s in zip(args, shards)))
                   for i, d in enumerate(plan.data_devices)]
        sizes = [x.shape[0] for x in next(s for s in shards if s is not None)]
        return mesh.reduce_shards(plan, results, sizes)

    return run


def make_train_step(loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
                    tx: AdamWithClip, remat: bool = False, frozen: Any = None,
                    plan: Optional[mesh.MeshPlan] = None):
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
    same gradients). plan: a data mesh; the loss then runs per shard
    through `shard_loss` (tensor arguments are the batch), with `frozen`
    replicated once here. The JAX package's `donate` has no meaning here
    (the step updates the parameters in place) and is not an argument.
    """
    if frozen is not None:
        freeze(frozen)
        if plan is not None:
            frozen = mesh.replicate(plan, frozen)

    def run(params, *args):
        if remat:
            return checkpoint(loss_fn, params, *args, use_reentrant=False)
        return loss_fn(params, *args)

    if plan is not None:
        run = shard_loss(plan, run)

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
