"""NVlabs persistence-pickle loader (`StyleGAN/ffhq.pkl`) + D converter
(counterpart of hairfastgan_tpu/params/nvlabs.py; the port keeps its own
copy, numpy and torch only).

The reference starts PostProcess adversarial training from the pretrained
StyleGAN2-ADA discriminator, loaded via `_LegacyUnpickler`
(reference utils/train.py:71-77) + `torch_utils/persistence.py:35-102`, a
scheme that EXECUTES Python source code embedded in the pickle to rebuild
the original classes. (The TF-legacy branch of that unpickler references an
undefined `_TFNetworkStub`, i.e. it is broken as shipped for TF pickles.)

Here the embedded source is never executed: persistence-pickled objects
reduce to `_reconstruct_persistent_obj({'type','version','module_src',
'class_name','state'})` (persistence.py:119-126), and `state` is just the
nn.Module `__dict__`: `_parameters` / `_buffers` / nested `_modules`. The
unpickler below reconstructs lightweight stubs from that state, walks them
into a flat state dict, and maps it onto the tree of
models/stylegan2_discriminator.py (rosinality's residual config-f D is a
faithful port of NVlabs'; both apply equalized-LR scaling at run time, so
weights transfer as they are, OIHW convs and [out, in] linears).
"""

from __future__ import annotations

import io
import math
import pickle
from typing import Dict

import numpy as np
import torch

Array = np.ndarray


class NVStub:
    """Placeholder for a persistence-pickled object: holds its state only."""

    def __init__(self, class_name: str, state: dict):
        self.class_name = class_name
        self.state = state or {}

    def __repr__(self):
        return f"NVStub({self.class_name})"


def _reconstruct_stub(meta: dict) -> NVStub:
    return NVStub(meta.get("class_name", "?"), meta.get("state"))


class _TFLegacyStub:
    """dnnlib.tflib.network.Network entries (TF-era pickles). Unsupported:
    surfaced with a clear error instead of the reference's NameError."""

    def __setstate__(self, state):
        self.state = state


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj" and "persistence" in module:
            return _reconstruct_stub
        if name == "Network" and "tflib" in module:
            return _TFLegacyStub
        if name == "EasyDict" and "dnnlib" in module:
            return dict
        if module == "torch.storage" and name == "_load_from_bytes":
            # CUDA-saved storages: force CPU restore
            return lambda b: torch.load(io.BytesIO(b), map_location="cpu")
        return super().find_class(module, name)


def load_nvlabs_pickle(path: str) -> Dict[str, NVStub]:
    """ffhq.pkl -> {'G': NVStub, 'D': NVStub, 'G_ema': NVStub, ...}."""
    with open(path, "rb") as f:
        data = _StubUnpickler(f).load()
    for v in (data.values() if isinstance(data, dict) else []):
        if isinstance(v, _TFLegacyStub):
            raise ValueError(
                f"{path} is a TF-legacy pickle (dnnlib.tflib Network); only "
                "torch persistence pickles are supported: convert it with "
                "NVlabs' legacy.py first")
    return data


def stub_state_dict(stub, prefix: str = "") -> Dict[str, Array]:
    """Walk an NVStub tree exactly like nn.Module.state_dict()."""
    st = stub.state if isinstance(stub, NVStub) else stub
    out: Dict[str, Array] = {}
    for k, v in (st.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = v.detach().cpu().numpy()
    for k, v in (st.get("_buffers") or {}).items():
        if v is not None:
            out[prefix + k] = v.detach().cpu().numpy()
    for k, child in (st.get("_modules") or {}).items():
        if child is not None:
            out.update(stub_state_dict(child, prefix + k + "."))
    return out


def _t(a: Array) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def convert_nvlabs_discriminator(sd: Dict[str, Array], size: int = 1024) -> dict:
    """StyleGAN2-ADA D state dict -> models/stylegan2_discriminator tree.

    Key map (ada networks.Discriminator, resnet architecture):
      b{size}.fromrgb          -> conv_in        (1x1 + FusedLeakyReLU)
      b{res}.conv0             -> blocks[j].conv1 (3x3 same-res)
      b{res}.conv1             -> blocks[j].conv2 (3x3 blur-down)
      b{res}.skip              -> blocks[j].skip  (1x1 blur-down, no bias)
      b4.conv / b4.fc / b4.out -> final_conv / final_linear1 / final_linear2

    Both sides scale weights by 1/sqrt(fan_in) at run time and use
    lrelu(x+b)*sqrt(2); NVlabs' per-branch sqrt(0.5) gains equal
    rosinality's (h+s)/sqrt(2); the resample FIR is the same normalized
    (1,3,3,1). The ada models' conv_clamp=256 is dropped (inference-scale
    activations stay far below it).
    """
    def conv(name, bias=True):
        p = {"conv": {"w": _t(sd[f"{name}.weight"])}}
        if bias:
            p["bias"] = _t(sd[f"{name}.bias"])
        return p

    def fc(name):
        return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}

    p = {"conv_in": conv(f"b{size}.fromrgb"), "blocks": [], "final_conv": conv("b4.conv"),
         "final_linear1": fc("b4.fc"), "final_linear2": fc("b4.out")}
    for res in (2 ** i for i in range(int(math.log2(size)), 2, -1)):
        n = f"b{res}"
        p["blocks"].append({"conv1": conv(f"{n}.conv0"), "conv2": conv(f"{n}.conv1"),
                            "skip": conv(f"{n}.skip", bias=False)})
    return p


def load_nvlabs_discriminator(path: str, size: int = 1024) -> dict:
    """One-call path for scripts/train_pp.py --use_adv: ffhq.pkl -> D tree
    on the CPU (reference scripts/pp_train.py:59-63)."""
    data = load_nvlabs_pickle(path)
    if "D" not in data:
        raise KeyError(f"{path} has no 'D' entry (keys: {list(data)})")
    return convert_nvlabs_discriminator(stub_state_dict(data["D"]), size=size)
