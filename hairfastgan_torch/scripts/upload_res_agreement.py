"""What `swap(upload_res=512)` (reduced-upload serving) costs in numerics,
for both host resizes side by side (counterpart of the JAX package's
scripts/upload_res_agreement.py):

    python -m hairfastgan_torch.scripts.upload_res_agreement [--n 64] [--device cpu]

The pipeline reads the photo only at its fixed working spaces: BiSeNet at
512, e4e / FSE at 256 (pipeline/embedding.py). upload_res moves the first
2x downsample to the host (a uint8 resize) in place of the device's
bicubic; everything downstream is unchanged. This script measures what
that substitution changes where the pipeline reads:

  seg_agreement      256-label BiSeNet agreement (scaled-random weights:
                     the zoo's flat 0.05 weights collapse the argmax)
  hair_iou           IoU of the hair mask (the label the pipeline
                     thresholds on, cfg.hair_label); null when neither
                     side has a hair pixel
  e4e_in_rmse        RMSE of the [-1,1] 256-space encoder input
  fse_in_rmse        RMSE of the FSE iterated-bilinear 256 input

for the native Keys bicubic (`keys`: utils/images.to_image_u8's route,
through the resize-only library) and for PIL's LANCZOS (`lanczos`:
to_image_u8's route where that library does not build). Inputs are
smooth random fields (32^2 noise bicubic-upsampled to 1024^2, seeded):
resampling differences on white noise are a worst case no photo shows.
The BiSeNet weights follow the JAX package's init law (conv 0.02 * N(0,1),
identity BatchNorm), drawn with numpy from BISENET_SEED = 6: the first
seed under which the hair label wins on a fair share of these fields
(about 28% of the pixels; seeds 0-4 give 0-0.1%, where hair_iou is
undefined or rests on a handful of pixels). --device defaults to cuda and
raises without a GPU. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hairfastgan_torch.scripts import device_from_arg

HAIR = 13  # CelebA 256-space hair label (global_value_utils.py:49-52)
BISENET_SEED = 6  # hair wins on ~28% of the smooth fields (module docstring)


def scaled_bisenet(seed: int = BISENET_SEED, device="cpu"):
    """Full-width 19-class BiSeNet with the JAX package's init law (conv
    weights 0.02 * N(0,1), zero biases, identity BatchNorm), from a numpy seed."""
    from hairfastgan_torch.models import bisenet
    from hairfastgan_torch.params.bridge import map_tree, to_port

    rng = np.random.default_rng(seed)
    fixed = {"gamma": 1.0, "var": 1.0, "beta": 0.0, "mean": 0.0, "b": 0.0}

    def leaf(key, t):
        shape = tuple(t.shape)
        a = (np.full(shape, fixed[key], np.float32) if key in fixed
             else rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))
        return to_port(key, torch.from_numpy(a)).to(device)

    return map_tree(bisenet.init_bisenet(n_classes=19), leaf)


def smooth_fields(rng: np.random.RandomState, b: int) -> np.ndarray:
    """[b,1024,1024,3] float32 in [0,1]: 32^2 uniform noise, PIL-bicubic up."""
    from PIL import Image

    low = rng.rand(b, 32, 32, 3).astype(np.float32)
    return np.stack([np.asarray(Image.fromarray((lo * 255).astype(np.uint8)).resize(
        (1024, 1024), Image.BICUBIC)) for lo in low]).astype(np.float32) / 255.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--upload_res", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    return ap


class _Tally:
    """The four agreement numbers of one host resize, accumulated over batches."""

    def __init__(self):
        self.agree = self.nonmodal_agree = self.inter = self.union = 0.0
        self.e4e_se = self.fse_se = 0.0
        self.n_pix = self.n_nonmodal = 0

    def add(self, ref, got) -> None:
        (seg_a, e4e_a, fse_a), (seg_b, e4e_b, fse_b) = ref, got
        self.agree += (seg_a == seg_b).sum()
        self.n_pix += seg_a.size
        modal = np.bincount(seg_a.ravel(), minlength=19).argmax()
        nm = seg_a != modal
        self.nonmodal_agree += ((seg_a == seg_b) & nm).sum()
        self.n_nonmodal += nm.sum()
        ha, hb = seg_a == HAIR, seg_b == HAIR
        self.inter += (ha & hb).sum()
        self.union += (ha | hb).sum()
        self.e4e_se += ((e4e_a - e4e_b) ** 2).sum()
        self.fse_se += ((fse_a - fse_b) ** 2).sum()

    def result(self, n: int) -> dict:
        n_in = n * 256 * 256 * 3
        return {"seg_agreement": round(float(self.agree / self.n_pix), 4),
                "seg_agreement_nonmodal": round(float(self.nonmodal_agree
                                                      / max(self.n_nonmodal, 1)), 4),
                # None where neither side has a hair pixel (random weights
                # may never pick the label): an IoU of nothing is not 0
                "hair_iou": round(float(self.inter / self.union), 4) if self.union else None,
                "e4e_in_rmse": round(float(np.sqrt(self.e4e_se / n_in)), 5),
                "fse_in_rmse": round(float(np.sqrt(self.fse_se / n_in)), 5)}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch.data import native_loader
    from hairfastgan_torch.models import bisenet
    from hairfastgan_torch.pipeline.embedding import fse_downscale, to_res
    from hairfastgan_torch.utils.images import resize_u8_lanczos, to_image_u8

    if not native_loader.resize_available():
        raise RuntimeError(f"no native Keys resize: {native_loader.resize_error()}")
    zoo_b = scaled_bisenet(BISENET_SEED, device)
    up = args.upload_res

    @torch.no_grad()
    def reads(img01: np.ndarray):
        """What the program computes from NHWC [0,1] images at the
        pipeline's working spaces, as numpy."""
        x = torch.from_numpy(img01).to(device).permute(0, 3, 1, 2)
        seg = bisenet.segment_256_nchw(zoo_b, to_res(x, 512))
        return (seg.cpu().numpy(), (to_res(x, 256) * 2.0 - 1.0).cpu().numpy(),
                fse_downscale(x * 2.0 - 1.0).cpu().numpy())

    rng = np.random.RandomState(0)
    tallies = {"keys": _Tally(), "lanczos": _Tally()}
    for start in range(0, args.n, args.batch):
        imgs = smooth_fields(rng, min(args.batch, args.n - start))
        u8 = [(im * 255 + 0.5).astype(np.uint8) for im in imgs]
        ref = reads(imgs)  # the full-resolution upload
        for name, coerce in (("keys", to_image_u8), ("lanczos", resize_u8_lanczos)):
            small = np.stack([coerce(im, up) for im in u8]).astype(np.float32) / 255.0
            tallies[name].add(ref, reads(small))

    out = {"upload_res": up, "n": args.n, **{k: t.result(args.n) for k, t in tallies.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
