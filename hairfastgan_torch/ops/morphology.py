"""Binary dilate/erode with a 3x3 cross: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (csrc/morphology.cu).

Counterparts: hairfastgan_tpu/ops/morphology.py (plain) and the Pallas TPU
kernel hairfastgan_tpu/ops/pallas_morphology.py:55 `dilate_erode_pallas`.
Reference: utils/image_utils.py:27-55 runs N iterations of a float conv
with the cross kernel, thresholded (>0 dilate, ==5 erode); for binary masks
that is N-fold morphological dilate/erode, with the zero padding making the
border count as background for both.

`dilate_erode` dispatches on the tensor's device: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. The kernel is
built with nvcc at first use into hairfastgan_torch/_build/ (keyed by the
source's hash) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "morphology.cu"
BUILD_DIR = _PKG / "_build"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cross(x: Tensor, op) -> Tensor:
    """op (torch.maximum or torch.minimum) over the 3x3 cross of [B,H,W]
    planes, zero outside."""
    up = F.pad(x[:, 1:], (0, 0, 0, 1))
    dn = F.pad(x[:, :-1], (0, 0, 1, 0))
    lf = F.pad(x[:, :, 1:], (0, 1))
    rt = F.pad(x[:, :, :-1], (1, 0))
    return op(op(op(up, dn), op(lf, rt)), x)


def dilate_erode_reference(mask: Tensor, iterations: int = 5) -> Tuple[Tensor, Tensor]:
    """Plain version: (dilated, eroded) of [B,H,W,1] masks after `iterations`
    rounds (shift + max/min), in the input dtype."""
    b = (mask[..., 0] > 0).to(mask.dtype)
    d = e = b
    for _ in range(iterations):
        d, e = _cross(d, torch.maximum), _cross(e, torch.minimum)
    return d[..., None], e[..., None]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the morphology kernel "
                       "is built from csrc/morphology.cu at first use")


def build() -> Path:
    """Compile csrc/morphology.cu for sm_90a into a library keyed by the
    source's hash (no-op when already built); the ptxas report lands beside
    it as .log."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"morphology_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)  # ptxas report
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return so


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.hf_dilate_erode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hf_dilate_erode.restype = ctypes.c_int
    return lib


def _launch(mask: Tensor, iterations: int) -> Tuple[Tensor, Tensor]:
    if mask.dtype not in _DTYPES:
        raise TypeError(f"dilate_erode kernel takes float32 or bfloat16, got {mask.dtype}")
    if mask.ndim != 4 or mask.shape[-1] != 1 or min(mask.shape[:3]) < 1:
        raise ValueError(f"dilate_erode kernel takes non-empty [B,H,W,1], got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("dilate_erode kernel takes a contiguous mask")
    if not isinstance(iterations, int) or iterations < 0:
        raise ValueError(f"iterations must be an int >= 0, got {iterations!r}")
    b, h, w, _ = mask.shape
    lib = _library()
    dil = torch.empty_like(mask)
    ero = torch.empty_like(mask)
    with torch.cuda.device(mask.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.hf_dilate_erode(mask.data_ptr(), dil.data_ptr(), ero.data_ptr(),
                                  b, h, w, iterations, _DTYPES[mask.dtype], stream)
    if err != 0:  # 1 = cudaErrorInvalidValue: more than 65535 masks, more than
        # 256 iterations or 2,097,120 rows (csrc/morphology.cu)
        raise RuntimeError(f"dilate_erode kernel launch failed: cudaError {err} "
                           f"for [B,H,W]={[b, h, w]}, iterations={iterations}")
    dilate_erode.launches += 1
    return dil, ero


def dilate_erode(mask: Tensor, iterations: int = 5) -> Tuple[Tensor, Tensor]:
    """(dilated, eroded) of binary [B,H,W,1] masks, in the input dtype.

    CUDA tensor: the hand-written kernel (counted in `dilate_erode.launches`).
    CPU tensor: the plain version. Any other device raises.
    """
    if mask.device.type == "cuda":
        return _launch(mask, iterations)
    if mask.device.type == "cpu":
        return dilate_erode_reference(mask, iterations)
    raise RuntimeError(f"dilate_erode has no path for device {mask.device}")


dilate_erode.launches = 0
