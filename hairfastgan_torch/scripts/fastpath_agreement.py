"""What the two rotate-render fast paths cost in labels (counterpart of the
JAX package's scripts/fastpath_agreement.py):

    python -m hairfastgan_torch.scripts.fastpath_agreement [--n 100] [--batch 4] [--device cpu]

The rotated render of the shape module feeds only the BiSeNet
re-segmentation, whose 256 labels feed the shape adaptor
(pipeline/alignment._rotate_and_segment). Two opt-ins approximate it:
  rot_seg_size=512    parse the render downsampled to 512 (the reference
                      parses the full 1024 render, Alignment.py:65-67)
  rot_render_pairs=6  stop the synthesis at pair 6 (the 256^2 partial ToRGB
                      skip sum)
Over --n random W+ latents this measures, for each fast path and both
together, the 256-label agreement with the exact path, the agreement on the
pixels off the exact labels' most common class, and the hair-mask IoU.

Weights follow the JAX package's init laws, drawn with numpy: the
generator's weights and constant input N(0,1) (the equalized-lr scale
applies at run time), modulation biases 1, other biases and noise weights
0; BiSeNet as upload_res_agreement.scaled_bisenet draws it (conv 0.02 *
N(0,1), identity BatchNorm). The zoo's flat 0.05 fill collapses BiSeNet's
argmax onto one label. The latents are N(0,1) * 0.7 from a torch.Generator
seeded with --seed; renders and parses run in bf16. --device defaults to
cuda and raises without a GPU. Prints the JSON object the JAX script prints;
`measure` takes the generator's StyleGANConfig (the cuts are the JAX
script's, so it is a 1024^2 one; tests narrow its channels).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hairfastgan_torch.scripts import device_from_arg
from hairfastgan_torch.scripts.upload_res_agreement import BISENET_SEED, scaled_bisenet

HAIR = 13  # HairFastConfig.hair_label


def scaled_generator(cfg, seed: int, device="cpu"):
    """The generator at `cfg` (a StyleGANConfig) with the JAX package's init
    law, from a numpy seed: every 'w' and the constant input N(0,1),
    modulation biases 1, other biases and noise weights 0 (drawn in JAX
    layout and sorted key order, as zoo.fill_random draws)."""
    from hairfastgan_torch.models import stylegan2
    from hairfastgan_torch.params.bridge import to_port

    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(tree[k], path + (k,)) for k in sorted(tree)}
        if isinstance(tree, list):
            return [fill(v, path) for v in tree]
        shape = tuple(tree.shape)
        if path[-1] in ("w", "input"):
            a = rng.standard_normal(shape, dtype=np.float32)
        else:
            a = np.full(shape, 1.0 if path[-2:] == ("modulation", "b") else 0.0, np.float32)
        return to_port(path[-1], torch.from_numpy(a)).to(device)

    return fill(stylegan2.init_generator_params(cfg))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def measure(sg, n: int = 100, batch: int = 4, seed: int = 0, device="cpu",
            dtype: torch.dtype = torch.bfloat16) -> dict:
    """The agreement of each cut with the exact path over `n` latents, for
    the generator at `sg` (a StyleGANConfig), rendered in `dtype` -> the
    JAX script's JSON object."""
    from hairfastgan_torch.models import stylegan2
    from hairfastgan_torch.pipeline.alignment import parse_render

    device = torch.device(device)
    gen = scaled_generator(sg, seed, device)
    bis = scaled_bisenet(BISENET_SEED, device)
    full_pairs = sg.log_size - 2
    variants = {"exact": (full_pairs, 1024), "seg512": (full_pairs, 512),
                "pairs6": (6, 1024), "pairs6_seg512": (6, 512)}
    noise = stylegan2.make_noise(None, sg)

    @torch.no_grad()
    def render_and_parse(w, end_pair, seg_size):
        rgb = stylegan2.synthesis_nchw(gen, w, noise=noise, end_layer=end_pair, cfg=sg,
                                       dtype=dtype)[1]
        return parse_render(bis, rgb, seg_size).cpu().numpy()

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    agree = {k: [] for k in variants if k != "exact"}
    agree_nm = {k: [] for k in agree}  # agreement on the non-modal pixels only
    iou = {k: [] for k in agree}
    n_classes, nonmodal_px, n_done = 0, 0, 0
    for _ in range(0, n, batch):
        n_done += batch
        w = torch.randn((batch, sg.n_latent, 512), generator=g, device=device) * 0.7
        labs = {k: render_and_parse(w, ep, ss) for k, (ep, ss) in variants.items()}
        ref = labs["exact"]
        # a degenerate parser (one class everywhere) shows in the class count
        # and in the agreement off the modal class
        hist = np.bincount(ref.ravel(), minlength=19)
        nonmodal = ref != int(hist.argmax())
        n_classes = max(n_classes, int((hist > 0).sum()))
        nonmodal_px += int(nonmodal.sum())
        for k in agree:
            eq = labs[k] == ref
            agree[k].append(float(eq.mean()))
            agree_nm[k].append(float(eq[nonmodal].mean()) if nonmodal.any() else 1.0)
            h, hr = labs[k] == HAIR, ref == HAIR
            iou[k].append(float((h & hr).sum()) / max(float((h | hr).sum()), 1.0))

    out = {k: {"label_agreement": round(float(np.mean(agree[k])), 5),
               "nonmodal_agreement": round(float(np.mean(agree_nm[k])), 5),
               "hair_iou": round(float(np.mean(iou[k])), 5)} for k in agree}
    out["_diagnostics"] = {"classes_present": n_classes,
                           "nonmodal_px_frac": round(nonmodal_px / (n_done * 256 * 256), 5)}
    return out


def main(argv=None) -> dict:
    from hairfastgan_torch.config import StyleGANConfig

    args = parser().parse_args(argv)
    out = measure(StyleGANConfig(), args.n, args.batch, args.seed, device_from_arg(args.device))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
