"""Host-side image IO and coercion: the part of the pipeline before the
upload to the device.

Takes the inputs of reference hair_swap.py:76-91 (path / PIL / ndarray),
the uint8 -> [0,1] float conversion of datasets/image_dataset.py:5-29, and
utils/image_utils.equal_replacer's identity dedup (:15-24).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Union

import numpy as np
from PIL import Image

from hairfastgan_torch.data import native_loader
from hairfastgan_torch.utils import timing

TImage = Union[np.ndarray, Image.Image, str, Path]


def to_raw_image(img: TImage) -> np.ndarray:
    """Anything -> [H,W,3] float32 in [0,1] at the ORIGINAL size.

    The alignment path crops a quad from the original pixels (the reference
    runs dlib on the unresized photo, utils/shape_predictor.py:49-77);
    squashing to the generator size first would warp the geometry.
    """
    if isinstance(img, (str, Path)):
        img = Image.open(str(img)).convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def to_image_array(img: TImage, size: int = 1024) -> np.ndarray:
    """Anything -> [size,size,3] float32 in [0,1] (LANCZOS resize when needed)."""
    arr = to_raw_image(img)
    if arr.shape[:2] != (size, size):
        pil = Image.fromarray((arr * 255).astype(np.uint8))
        arr = np.asarray(pil.resize((size, size), Image.LANCZOS)).astype(np.float32) / 255.0
    return arr


@timing.span("upload")
def to_image_u8(img: TImage, size: int = 1024) -> np.ndarray:
    """Anything -> [size,size,3] uint8 (the device normalizes; 1/4 of the
    float bytes to upload). An `upload` span.

    A uint8 [size,size,3] array passes through without a copy. A uint8
    [H,W,3] array of another size is resized by the native Keys bicubic
    (the kernel of the device resampler, from the codec-free resize-only
    library), or by PIL's LANCZOS where that library does not build
    (`native_loader.resize_error()` says why).
    """
    if isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3 \
            and img.shape[-1] == 3:
        if img.shape[:2] == (size, size):
            return img
        if native_loader.resize_available():
            return native_loader.resize_u8_native(img, size)
        return resize_u8_lanczos(img, size)
    arr = to_image_array(img, size)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def resize_u8_lanczos(img: np.ndarray, size: int) -> np.ndarray:
    """[H,W,3] uint8 -> [size,size,3] uint8 by PIL's LANCZOS: to_image_u8's
    route where the native resize does not build. Resampling u8 directly
    equals the float round trip of to_image_array (PIL resamples the same
    8-bit samples) without two float conversions."""
    return np.asarray(Image.fromarray(img).resize((size, size), Image.LANCZOS))


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """allclose, short-circuited by a strided sample: a differing sample
    already proves inequality, so three distinct photos skip the full compare."""
    if a.shape != b.shape:
        return False
    if not np.allclose(a[::31, ::37], b[::31, ::37]):
        return False
    if a.dtype == np.uint8 and b.dtype == np.uint8:
        return np.array_equal(a, b)  # allclose's tolerances are < 1 step of uint8
    return np.allclose(a, b)


def equal_replacer(images: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Replace value-equal arrays with the SAME object, so the identity dedup
    of the swap's cases fires (reference utils/image_utils.py:15-24)."""
    out: List[np.ndarray] = []
    for img in images:
        for prev in out:
            if img is prev or _same_values(img, prev):
                img = prev
                break
        out.append(img)
    return out


def save_image01(path: Union[str, Path], img01: np.ndarray) -> None:
    """[H,W,3] or [1,H,W,3] float in [0,1] (or uint8) -> image file."""
    arr = np.asarray(img01)
    if arr.ndim == 4:
        arr = arr[0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))
