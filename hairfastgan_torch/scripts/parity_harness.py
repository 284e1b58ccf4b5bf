"""Full-pipeline numerical parity harness against the PyTorch reference
(counterpart of the JAX package's scripts/parity_harness.py).

Compares EVERY stage of one hair transfer against the reference's own
`--save_all` artifact dump (the per-stage golden-tensor strategy of
SURVEY.md §4), in both noise modes, and exits nonzero on any regression:
with real checkpoints in place, one command checks the port against the
reference.

Reference-side dump (in the reference repo, with its checkpoints):

    python main.py --save_all --save_all_dir golden_out \\
        --face_path face.png --shape_path shape.png --color_path color.png \\
        --input_dir . --output_dir out
    # artifacts land in golden_out/<face_shape_color>/

Then, with the reference checkpoints (or their zoo_torch.pt) in --zoo_dir:

    python -m hairfastgan_torch.scripts.parity_harness --golden_dir golden_out/<exp> \\
        --face face.png --shape shape.png --color color.png \\
        --zoo_dir pretrained_models [--noise] [--device cpu]

Golden layout consumed (reference save paths):
  W+/{face,shape,color}.npz   latent_W        (Embedding.py:112)
  FS/{name}.npz               latent_S/F      (Embedding.py:116)
  Shape/mask_{name}.png       vis masks       (Alignment.py:90-93)
  Align/face_shape_F.npz      latent_F_align  (Alignment.py:179)
  Blending/blending.npz       S_blend         (Blending.py:75)
  Final/final.npz + final.png S/F_final, img  (Blending.py:77-78)

The run is `pipeline/swap.hair_fast` in f32 on --device (default cuda,
raising without a GPU). Its intermediates keep the JAX package's layouts
(NHWC F tensors), which the golden's NCHW latents are transposed to.
Zero-noise mode compares tightly; --noise re-runs with fresh gaussian noise
(the reference's StyledConv behaviour): RNGs of two frameworks cannot match
sample for sample, so image-valued stages get a loose tolerance there while
the encoders' latents stay tight.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from hairfastgan_torch.scripts import device_from_arg


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-8))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def load_png01(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def decode_vis_mask(path):
    """Color PNG (CtrlHair palette) -> int labels; unknown colors -> -1."""
    from hairfastgan_torch.utils.save_utils import PARSING_COLORS

    rgb = (load_png01(path) * 255.0 + 0.5).astype(np.uint8)
    lab = -np.ones(rgb.shape[:2], np.int32)
    for i, c in enumerate(PARSING_COLORS):
        lab[np.all(rgb == c, axis=-1)] = i
    return lab


def torch_f_to_nhwc(f):
    """Golden latent_F is NCHW [1,512,32,32] -> NHWC [32,32,512]."""
    f = np.asarray(f)
    if f.ndim == 4:
        f = f[0]
    return np.transpose(f, (1, 2, 0))


def resize_labels(labels: np.ndarray, hw) -> np.ndarray:
    """[H,W] int labels -> `hw` by nearest (ops/resample's floor indexing)."""
    import torch

    from hairfastgan_torch.ops.resample import resize

    return resize(torch.from_numpy(np.asarray(labels)), tuple(hw), "nearest").numpy()


class Report:
    def __init__(self):
        self.failures = []

    def check(self, name, err, tol):
        ok = err <= tol
        print(f"[{'OK ' if ok else 'FAIL'}] {name}: {err:.5f} (tol {tol})")
        if not ok:
            self.failures.append(name)

    def check_ge(self, name, val, floor):
        ok = val >= floor
        print(f"[{'OK ' if ok else 'FAIL'}] {name}: {val:.4f} (>= {floor})")
        if not ok:
            self.failures.append(name)


def compare_run(inter, final, g, args, mode, rep):
    """Compare one pipeline run (numpy intermediates under hair_fast's keys,
    NHWC final image) against the golden directory `g`."""
    g = Path(g)
    loose = 5.0 if mode == "noise" else 1.0
    tol = args.tol
    # image-valued / noise-touched stages get the loose factor in noise mode;
    # the inputs' encoder latents (W/S/F) never see noise
    for name in ("face", "shape", "color"):
        wz = np.load(g / "W+" / f"{name}.npz")
        fz = np.load(g / "FS" / f"{name}.npz")
        rep.check(f"{mode}:W_{name}", rel_err(inter[f"W_{name}"][0], wz["latent_W"].squeeze(0)),
                  tol)
        rep.check(f"{mode}:S_{name}", rel_err(inter[f"S_{name}"][0], fz["latent_S"].squeeze(0)),
                  tol)
        rep.check(f"{mode}:F_{name}",
                  rel_err(inter[f"F_{name}"][0], torch_f_to_nhwc(fz["latent_F"])), tol)

    # masks: 256-label agreement against the decoded vis PNGs
    for name in ("face", "shape", "color"):
        p = g / "Shape" / f"mask_{name}.png"
        if p.exists():
            ref_lab = decode_vis_mask(p)
            ours = np.asarray(inter[f"mask_{name}"][0])
            if ref_lab.shape != ours.shape:
                ours = resize_labels(ours, ref_lab.shape)
            rep.check_ge(f"{mode}:mask_{name} agreement", float((ours == ref_lab).mean()),
                         args.mask_floor)

    az = np.load(g / "Align" / "face_shape_F.npz")
    rep.check(f"{mode}:latent_F_align",
              rel_err(inter["latent_F_align"][0], torch_f_to_nhwc(az["latent_F_align"])),
              tol * loose)

    bz = np.load(g / "Blending" / "blending.npz")
    rep.check(f"{mode}:S_blend", rel_err(inter["S_blend"][0], bz["S_blend"].squeeze(0)),
              tol * loose)

    fz = np.load(g / "Final" / "final.npz")
    rep.check(f"{mode}:S_final", rel_err(inter["S_final"][0], fz["S_final"].squeeze(0)),
              tol * loose)
    rep.check(f"{mode}:F_final", rel_err(inter["F_final"][0], torch_f_to_nhwc(fz["F_final"])),
              tol * loose)

    ref_final = load_png01(g / "Final" / "final.png")
    rep.check_ge(f"{mode}:final PSNR", psnr(final[0], ref_final),
                 args.psnr_floor if mode == "zero" else args.psnr_floor - 6.0)


def run_pipeline(zoo, imgs, cfg, generator=None):
    """hair_fast in f32 with its intermediates, as numpy: (final, inter)."""
    import torch

    from hairfastgan_torch.pipeline.swap import hair_fast

    with torch.inference_mode():
        final, inter = hair_fast(zoo, *imgs, case="distinct", cfg=cfg, dtype=torch.float32,
                                 generator=generator, return_intermediate=True)
    return final.float().cpu().numpy(), {k: v.float().cpu().numpy() if v.is_floating_point()
                                         else v.cpu().numpy() for k, v in inter.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden_dir", type=Path, required=True,
                    help="reference save_all_dir/<exp> directory")
    ap.add_argument("--face", type=Path, required=True)
    ap.add_argument("--shape", type=Path, required=True)
    ap.add_argument("--color", type=Path, required=True)
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--tol", type=float, default=0.02,
                    help="mean relative error budget per latent stage")
    ap.add_argument("--mask_floor", type=float, default=0.98)
    ap.add_argument("--psnr_floor", type=float, default=30.0,
                    help="final-image PSNR floor (zero-noise)")
    ap.add_argument("--noise", action="store_true",
                    help="additionally run with fresh-gaussian noise (reference StyledConv "
                         "default) at loose tolerance")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    import torch

    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.utils.images import to_image_array
    from hairfastgan_torch.zoo import load_zoo

    cfg = HairFastConfig()
    zoo = load_zoo(args.zoo_dir, cfg, device)
    size = cfg.stylegan.size
    imgs = [torch.from_numpy(to_image_array(p, size))[None].to(device)
            for p in (args.face, args.shape, args.color)]

    rep = Report()
    final, inter = run_pipeline(zoo, imgs, cfg)
    compare_run(inter, final, args.golden_dir, args, "zero", rep)
    if args.noise:
        gen = torch.Generator(device=device).manual_seed(3407)
        final, inter = run_pipeline(zoo, imgs, cfg, generator=gen)
        compare_run(inter, final, args.golden_dir, args, "noise", rep)

    if rep.failures:
        raise SystemExit(f"parity failures: {rep.failures}")
    print("all stages within tolerance")


if __name__ == "__main__":
    main()
