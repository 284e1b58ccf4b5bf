"""ctypes binding of the native C++ image loader (native/hf_loader.cpp):
threaded libjpeg/libpng decode and a separable Keys (a=-0.75) bicubic resize
into uint8 [H,W,3] buffers, for swap_stream and the upload_res coercion.

The library is built from the repository's source with g++ at first use into
hairfastgan_torch/_build/, and never taken from a prebuilt file. Where the
build or the load fails, `native_available()` is False and `native_error()`
says why; callers decode with PIL instead, the host-decode route of
utils/images.

The resize needs no codec, so `resize_u8_native` always takes the
resize-only library built from csrc/resize_u8.cpp, a copy of the loader's
resize: the upload_res coercion keeps the device resampler's kernel, and the
same bytes, on a host without libjpeg / libpng headers too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import warnings
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "hf_loader.cpp"
RESIZE_SOURCE = _PKG / "csrc" / "resize_u8.cpp"
BUILD_DIR = _PKG / "_build"
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def _build_so(source: Path, stem: str, libs) -> Path:
    """Compile `source` for the host it runs on (-march=native, the flags of
    the loader's own build line) into a library keyed by the source's hash
    and the host's name; no-op when already built."""
    key = source.read_bytes() + platform.node().encode()
    so = BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(source), "-o", str(tmp),
           *libs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {res.stderr.strip()[-2000:]}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return so


def build() -> Path:
    """The full loader: native/hf_loader.cpp, linked with libjpeg and libpng.
    Its hfl_resize_u8 is bound too, as the reference the resize-only
    library is tested against."""
    return _build_so(SOURCE, "hf_loader", ["-ljpeg", "-lpng", "-lpthread"])


def build_resize() -> Path:
    """The resize-only library: csrc/resize_u8.cpp, no codec."""
    return _build_so(RESIZE_SOURCE, "resize_u8", [])


def _bind_resize(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hfl_resize_u8.restype = ctypes.c_int
    lib.hfl_resize_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    return lib


@functools.lru_cache(maxsize=1)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None), or (None, why it could not be built or loaded)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:  # no g++, no libjpeg/libpng, a bad load
        return None, f"{type(e).__name__}: {e}"
    lib.hfl_create2.restype = ctypes.c_void_p
    lib.hfl_create2.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.hfl_next_bytes.restype = ctypes.c_int
    lib.hfl_next_bytes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.hfl_destroy.restype = None
    lib.hfl_destroy.argtypes = [ctypes.c_void_p]
    return _bind_resize(lib), None


@functools.lru_cache(maxsize=1)
def _load_resize_only() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(the resize-only library, None), or (None, why it could not be built or loaded)."""
    try:
        return _bind_resize(ctypes.CDLL(str(build_resize()))), None
    except (OSError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {e}"


def native_available() -> bool:
    return _load()[0] is not None


def native_error() -> Optional[str]:
    """Why the native loader is unavailable (None when it loaded)."""
    return _load()[1]


def resize_available() -> bool:
    """True when the resize-only library (the native Keys-bicubic resize) loaded."""
    return _load_resize_only()[0] is not None


def resize_error() -> Optional[str]:
    """Why the resize-only library is unavailable (None when it loaded)."""
    return _load_resize_only()[1]


def _lib() -> ctypes.CDLL:
    lib, err = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {err}")
    return lib


def resize_u8_native(img: np.ndarray, out_size: int) -> np.ndarray:
    """[H,W,3] uint8 -> [out_size,out_size,3] uint8, Keys a=-0.75 bicubic:
    the kernel of the device resampler (ops/resample.resize bicubic), from
    the resize-only library."""
    lib, err = _load_resize_only()
    if lib is None:
        raise RuntimeError(f"no native resize is available: {err}")
    return _resize_with(lib, img, out_size)


def _resize_with(lib: ctypes.CDLL, img: np.ndarray, out_size: int) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"resize_u8_native takes [H,W,3] uint8, got {img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    out = np.empty((out_size, out_size, 3), np.uint8)
    if not lib.hfl_resize_u8(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                             out_size, out.ctypes.data_as(_U8P)):
        raise IOError("native resize failed")
    return out


class NativeImageLoader:
    """Threaded prefetching decoder over a list of paths: iterates (index,
    [out_size, out_size, 3] image) in completion order; a file that fails to
    decode is skipped with a warning. dtype np.uint8 (the default) gives the
    rounded bytes, np.float32 the library's [0,1] floats, resized before any
    rounding (the JAX package's loader's default)."""

    def __init__(self, paths: Sequence, out_size: int = 1024, threads: int = 4,
                 dtype=np.uint8):
        self._lib = _lib()
        self.paths = [str(p) for p in paths]
        self.out_size = out_size
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(f"dtype must be float32 or uint8, got {dtype}")
        names = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        # the library copies the paths; format 0 is float32 output, 1 uint8
        self._handle = self._lib.hfl_create2(names, len(self.paths), out_size, threads,
                                             int(self.dtype == np.uint8))

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        idx = ctypes.c_int(0)
        while self._handle:
            out = np.empty((self.out_size, self.out_size, 3), self.dtype)
            if not self._lib.hfl_next_bytes(self._handle, out.ctypes.data_as(ctypes.c_void_p),
                                            ctypes.byref(idx)):
                return
            if idx.value < 0:
                warnings.warn(f"decode failed: {self.paths[-idx.value - 1]}")
                continue
            yield idx.value, out

    def close(self) -> None:
        if self._handle:
            self._lib.hfl_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
