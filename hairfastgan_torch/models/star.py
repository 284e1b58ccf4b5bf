"""STAR landmark detector (StackedHGNetV1), PyTorch (counterpart of
hairfastgan_tpu/models/star.py).

CoordConv stem, pre-activation BN bottleneck ResBlocks, recursive
hourglasses, and per stack the AAM heads: heatmap (instance norm + ReLU),
point and edge maps (sigmoid), the fixed edge->point E2H transform, and a
soft-argmax decoder giving coordinates in [-1,1]. WFLW: classes (98, 9, 98),
4 stacks of 4-level hourglasses at 256 channels, 256^2 input. NCHW inside;
the public functions take NHWC, like the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import init_bn, init_conv
from hairfastgan_torch.ops.basic import batch_norm, conv2d_p, instance_norm

Tensor = torch.Tensor

WFLW_EDGE_INFO: Tuple[Tuple[bool, Tuple[int, ...]], ...] = (
    (False, tuple(range(33))),                      # FaceContour
    (True, tuple(range(33, 42))),                   # RightEyebrow
    (True, tuple(range(42, 51))),                   # LeftEyebrow
    (False, (51, 52, 53, 54)),                      # NoseLine
    (False, (55, 56, 57, 58, 59)),                  # Nose
    (True, tuple(range(60, 68))),                   # RightEye
    (True, tuple(range(68, 76))),                   # LeftEye
    (True, tuple(range(76, 88))),                   # OuterLip
    (True, tuple(range(88, 96))),                   # InnerLip
)
WFLW_CLASSES = (98, 9, 98)


def _init_convblock(k: int, cin: int, cout: int, bn: bool = False):
    p = {"conv": init_conv(k, cin, cout)}
    if bn:
        p["bn"] = init_bn(cout)
    return p


def _convblock(p, x: Tensor, *, stride: int = 1, bn: bool = False, act: bool = False) -> Tensor:
    k = p["conv"]["w"].shape[-1]
    y = conv2d_p(p["conv"], x, stride=stride, padding=(k - 1) // 2)
    if bn and "bn" in p:
        y = batch_norm(p["bn"], y)
    return torch.relu(y) if act else y


def init_resblock(cin: int, cout: int, mid: Optional[int] = None):
    mid = mid or cout // 2
    p = {"bn1": init_bn(cin), "conv1": _init_convblock(1, cin, mid),
         "bn2": init_bn(mid), "conv2": _init_convblock(3, mid, mid),
         "bn3": init_bn(mid), "conv3": _init_convblock(1, mid, cout)}
    if cin != cout:
        p["skip"] = _init_convblock(1, cin, cout)
    return p


def resblock(p, x: Tensor) -> Tensor:
    r = _convblock(p["skip"], x) if "skip" in p else x
    y = _convblock(p["conv1"], torch.relu(batch_norm(p["bn1"], x)))
    y = _convblock(p["conv2"], torch.relu(batch_norm(p["bn2"], y)))
    y = _convblock(p["conv3"], torch.relu(batch_norm(p["bn3"], y)))
    return y + r


@functools.lru_cache(maxsize=None)
def _coord_channels(h: int, w: int) -> np.ndarray:
    """[3, H, W]: x (along H), y (along W) in [-1,1] and the normalized
    radius, as the JAX package's `_coord_channels` (transposed to CHW)."""
    xx = np.tile((np.arange(h) / (h - 1) * 2 - 1)[:, None], (1, w))
    yy = np.tile((np.arange(w) / (w - 1) * 2 - 1)[None, :], (h, 1))
    rr = np.sqrt(xx ** 2 + yy ** 2)
    rr = rr / rr.max()
    return np.stack([xx, yy, rr]).astype(np.float32)


def coordconv(p, x: Tensor, boundary_heatmap: Optional[Tensor] = None, *, stride: int = 1,
              bn: bool = False, act: bool = False) -> Tensor:
    """CoordConv on NCHW maps: append x/y/r (+ boundary-gated x/y) channels
    then conv."""
    h, w = x.shape[-2:]
    coords = torch.from_numpy(_coord_channels(h, w)).to(x.device, x.dtype)
    coords = coords[None].expand(x.shape[0], -1, -1, -1)
    feats = [x, coords]
    if boundary_heatmap is not None:
        gate = (boundary_heatmap[:, -1:].clamp(0.0, 1.0) > 0.05).to(x.dtype)
        feats += [coords[:, 0:1] * gate, coords[:, 1:2] * gate]
    return _convblock(p, torch.cat(feats, dim=1), stride=stride, bn=bn, act=act)


def init_hourglass(n: int, f: int, add_coord: bool, first_one: bool):
    p = {"up1": init_resblock(f, f), "low1": init_resblock(f, f), "low3": init_resblock(f, f),
         "low2": init_hourglass(n - 1, f, False, False) if n > 1 else init_resblock(f, f)}
    if add_coord:
        p["coordconv"] = _init_convblock(1, f + (3 if first_one else 5), f)
    return p


def hourglass(p, x: Tensor, heatmap: Optional[Tensor] = None) -> Tensor:
    if "coordconv" in p:
        x = coordconv(p["coordconv"], x, heatmap)
    up1 = resblock(p["up1"], x)
    low = resblock(p["low1"], F.max_pool2d(x, 2, 2))
    low = hourglass(p["low2"], low) if "up1" in p["low2"] else resblock(p["low2"], low)
    low = resblock(p["low3"], low)
    return up1 + low.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest x2


def e2h_matrix(edge_info=WFLW_EDGE_INFO, num_points: int = 98,
               num_edges: int = 9) -> Tuple[np.ndarray, np.ndarray]:
    """The fixed edge -> point weights [points, edges] and bias [points]."""
    m = np.zeros((num_points, num_edges), np.float32)
    for e, (_, idxs) in enumerate(edge_info):
        m[list(idxs), e] = 1.0
    return m, (m.sum(1) < 0.5).astype(np.float32)


def init_star(classes=WFLW_CLASSES, edge_info=WFLW_EDGE_INFO, nstack: int = 4,
              nlevels: int = 4, channels: int = 256):
    """Shape tree of the JAX package's `init_star` (meta tensors, JAX
    layout), except the E2H weights: they are fixed, so they come as real
    tensors (zoo.fill_random keeps them)."""
    heats, edges, points = classes
    e2h_w, e2h_b = e2h_matrix(edge_info, points, edges)
    p = {"pre_conv": _init_convblock(7, 3 + 3, 64, bn=True),
         "pre_r1": init_resblock(64, 128), "pre_r2": init_resblock(128, 128),
         "pre_r3": init_resblock(128, channels), "stacks": [],
         "e2h_w": torch.from_numpy(e2h_w), "e2h_b": torch.from_numpy(e2h_b)}
    for i in range(nstack):
        stack = {"hg": init_hourglass(nlevels, channels, True, i == 0),
                 "feat_r": init_resblock(channels, channels),
                 "feat_c": _init_convblock(1, channels, channels, bn=True),
                 "out_heat": _init_convblock(1, channels, heats),
                 "out_point": _init_convblock(1, channels, points),
                 "out_edge": _init_convblock(1, channels, edges)}
        if i < nstack - 1:
            stack.update(merge_feat=_init_convblock(1, channels, channels),
                         merge_heat=_init_convblock(1, heats, channels),
                         merge_point=_init_convblock(1, points, channels),
                         merge_edge=_init_convblock(1, edges, channels))
        p["stacks"].append(stack)
    return p


def _soft_argmax(heatmap: Tensor, with_spread: bool = False):
    """[B,K,H,W] -> [B,K,2] (x, y) in [-1,1]; with `with_spread`, also the
    radial stddev [B,K] around it, in [-1,1] units (the confidence signal
    of the alignment gate)."""
    h, w = heatmap.shape[-2:]
    yy = torch.linspace(-1.0, 1.0, h, dtype=heatmap.dtype, device=heatmap.device)[:, None]
    xx = torch.linspace(-1.0, 1.0, w, dtype=heatmap.dtype, device=heatmap.device)[None, :]
    s = heatmap.sum(dim=(2, 3)).clamp(min=1e-6)
    y = (heatmap * yy).sum(dim=(2, 3)) / s
    x = (heatmap * xx).sum(dim=(2, 3)) / s
    lm = torch.stack([x, y], dim=-1)
    if not with_spread:
        return lm
    y2 = (heatmap * yy * yy).sum(dim=(2, 3)) / s
    x2 = (heatmap * xx * xx).sum(dim=(2, 3)) / s
    var = (x2 - x * x).clamp(min=0.0) + (y2 - y * y).clamp(min=0.0)
    return lm, var.sqrt()


def star_landmarks_nchw(p, img: Tensor, with_spread: bool = False):
    """Normalized (0.5/0.5) [B,3,256,256] -> [B,98,2] coords in [-1,1] (and
    the spread [B,98] with `with_spread`): the last stack's soft-argmax."""
    x = coordconv(p["pre_conv"], img, stride=2, bn=True, act=True)
    x = F.max_pool2d(resblock(p["pre_r1"], x), 2, 2)
    x = resblock(p["pre_r3"], resblock(p["pre_r2"], x))
    heatmaps = landmarks = None
    for i, st in enumerate(p["stacks"]):
        hg = hourglass(st["hg"], x, heatmap=heatmaps)
        feat = _convblock(st["feat_c"], resblock(st["feat_r"], hg), bn=True, act=True)
        heatmaps = torch.relu(instance_norm(_convblock(st["out_heat"], feat)))
        points = torch.sigmoid(_convblock(st["out_point"], feat))
        edges = torch.sigmoid(_convblock(st["out_edge"], feat))
        mask = torch.einsum("behw,pe->bphw", edges, p["e2h_w"].to(edges.dtype))
        mask = mask + p["e2h_b"].to(edges.dtype)[None, :, None, None]
        landmarks = _soft_argmax(mask * points * heatmaps, with_spread=with_spread)
        if i < len(p["stacks"]) - 1:
            x = (x + _convblock(st["merge_feat"], feat) + _convblock(st["merge_heat"], heatmaps)
                 + _convblock(st["merge_point"], points) + _convblock(st["merge_edge"], edges))
    return landmarks


def star_landmarks(p, img: Tensor, with_spread: bool = False):
    """NHWC [B,256,256,3] normalized (0.5/0.5) -> as star_landmarks_nchw."""
    return star_landmarks_nchw(p, img.permute(0, 3, 1, 2), with_spread=with_spread)


def keypoints_256(p, img01_256: Tensor, n_points: int = 76) -> Tensor:
    """[0,1] NHWC 256 image -> first n_points landmarks in pixel coords
    ((lm + 1) / 2 * 255)."""
    lm = star_landmarks(p, img01_256 * 2.0 - 1.0)
    return (lm[:, :n_points] + 1.0) / 2.0 * 255.0


def convert_star(sd, nstack: int = 4) -> dict:
    """STAR WFLW checkpoint ('net' state dict, numpy) -> init_star's tree
    (the counterpart of the JAX package's models/star.convert_star)."""
    from hairfastgan_torch.params.convert import t_bn, t_conv

    def cb(name, bn=False):
        out = {"conv": t_conv(sd, f"{name}.conv")}
        if bn:
            out["bn"] = t_bn(sd, f"{name}.bn")
        return out

    def rb(name):
        out = {"bn1": t_bn(sd, f"{name}.bn1"), "conv1": cb(f"{name}.conv1"),
               "bn2": t_bn(sd, f"{name}.bn2"), "conv2": cb(f"{name}.conv2"),
               "bn3": t_bn(sd, f"{name}.bn3"), "conv3": cb(f"{name}.conv3")}
        # torch builds skip_layer in every block; it is used where the widths differ
        if (f"{name}.skip_layer.conv.weight" in sd and sd[f"{name}.bn1.running_mean"].shape[0]
                != sd[f"{name}.conv3.conv.weight"].shape[0]):
            out["skip"] = cb(f"{name}.skip_layer")
        return out

    def hg(name, n):
        out = {"up1": rb(f"{name}.up1"), "low1": rb(f"{name}.low1"), "low3": rb(f"{name}.low3"),
               "low2": hg(f"{name}.low2", n - 1) if n > 1 else rb(f"{name}.low2")}
        if f"{name}.coordconv.conv.weight" in sd:
            out["coordconv"] = {"conv": t_conv(sd, f"{name}.coordconv.conv")}
        return out

    e2h_w, e2h_b = e2h_matrix(WFLW_EDGE_INFO, WFLW_CLASSES[2], WFLW_CLASSES[1])
    p = {"pre_conv": cb("pre.0", bn=True), "pre_r1": rb("pre.1"), "pre_r2": rb("pre.3"),
         "pre_r3": rb("pre.4"), "stacks": [],
         "e2h_w": torch.from_numpy(e2h_w), "e2h_b": torch.from_numpy(e2h_b)}
    for i in range(nstack):
        st = {"hg": hg(f"hgs.{i}", 4), "feat_r": rb(f"features.{i}.0"),
              "feat_c": cb(f"features.{i}.1", bn=True), "out_heat": cb(f"out_heatmaps.{i}"),
              "out_point": cb(f"out_pointmaps.{i}"), "out_edge": cb(f"out_edgemaps.{i}")}
        if i < nstack - 1:
            st.update(merge_feat=cb(f"merge_features.{i}"), merge_heat=cb(f"merge_heatmaps.{i}"),
                      merge_point=cb(f"merge_pointmaps.{i}"), merge_edge=cb(f"merge_edgemaps.{i}"))
        p["stacks"].append(st)
    return p
