"""Faults planted in the program's timed path, to show that a run whose
answers are wrong comes out not correct (portbench/tests/test_portbench_faults.py
on the micro zoo; `python3 -m portbench.calibrate --fault <name>` on the card,
at a cell's own size). Each is a context manager that patches the program
for its length:

  answer_altered  the served image's top eighth inverted where it is quantized
  half_batch      swap_batch computes the first half of each batch, serves it twice
  kernel_skipped  the dilate/erode kernel returns its input mask for both
                  outputs (its rounds skipped), in alignment and blending
  masks_rolled    blending's dilate/erode outputs come back with their rows
                  rotated by a third (the face's, color's and aligned hair
                  masks exchanged), as a batching slip would
  blend_skipped   the blending encoder returns the face's own style codes
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def patched(target: str, make):
    """target "module:attr" replaced by make(original) for the block."""
    mod_name, _, attr = target.partition(":")
    mod = importlib.import_module(mod_name)
    plain = getattr(mod, attr)
    setattr(mod, attr, make(plain))
    try:
        yield
    finally:
        setattr(mod, attr, plain)


def _inverted_top(plain):
    def altered(x):
        y = plain(x).clone()
        h = y.shape[1] // 8
        y[:, :h] = 255 - y[:, :h]
        return y
    return altered


def _half(plain):
    def half(zoo, face, shape, color, **kw):
        h = max(1, face.shape[0] // 2)
        out = plain(zoo, face[:h], shape[:h], color[:h], **kw)
        return torch.cat([out] * (face.shape[0] // h + 1))[:face.shape[0]]
    return half


def _unchanged(plain):
    def skipped(x, *a, **k):
        m = (x > 0).to(x.dtype)
        return m, m
    return skipped


def _rolled(plain):
    def rolled(x, *a, **k):
        dil, ero = plain(x, *a, **k)
        n = x.shape[0] // 3
        return dil.roll(n, dims=0), ero.roll(n, dims=0)
    return rolled


def _face_codes(plain):
    def skipped(params, s_face, s_color, *a, **k):
        return s_face
    return skipped


FAULTS = {
    "answer_altered": ("hairfastgan_torch.api:quantize_u8", _inverted_top),
    "half_batch": ("hairfastgan_torch.api:hair_fast", _half),
    "kernel_skipped": (("hairfastgan_torch.pipeline.alignment:dilate_erode",
                        "hairfastgan_torch.pipeline.blending:dilate_erode"), _unchanged),
    "masks_rolled": ("hairfastgan_torch.pipeline.blending:dilate_erode", _rolled),
    "blend_skipped": ("hairfastgan_torch.models.encoders:blending_model", _face_codes),
}


@contextlib.contextmanager
def planted(name: str):
    targets, make = FAULTS[name]
    with contextlib.ExitStack() as stack:
        for t in (targets if isinstance(targets, tuple) else (targets,)):
            stack.enter_context(patched(t, make))
        yield
