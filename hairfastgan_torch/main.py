"""CLI runner of the PyTorch port: one triple, or a file of triples.

    python -m hairfastgan_torch.main --face_path F --shape_path S --color_path C
    python -m hairfastgan_torch.main --file_path triples.txt --input_dir imgs --batch 8

Counterpart of the JAX package's main.py: either --face_path/--shape_path/
--color_path for one transfer, or --file_path with lines "face shape color"
relative to --input_dir. --batch N groups the triples by dedup case into
`swap_batch` calls of N. --tiny / --micro run 128^2 random-weight zoos with
the shapes of the JAX package's init_tiny_zoo / init_micro_zoo_fast (the
micro weights are exactly init_micro_zoo_fast(0)'s). --device defaults to
cuda and raises when no GPU is there; it never falls back to the CPU by
itself (pass --device cpu for that).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.api import HairFast, config_from_args, get_parser
from hairfastgan_torch.utils.images import save_image01, to_image_u8


def triple_case(face, shape, color) -> str:
    """Dedup case of a triple of paths, by path identity."""
    if face == shape == color:
        return "same"
    if shape == color:
        return "shape_eq_color"
    if face == shape:
        return "face_eq_shape"
    if face == color:
        return "face_eq_color"
    return "distinct"


def build(args: argparse.Namespace, cfg=None) -> HairFast:
    """HairFast on --device: the --tiny / --micro random zoo in f32, else
    `cfg` (default: the model flags' config; its checkpoint_dir is loaded
    when it exists)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if args.tiny or args.micro:
        from hairfastgan_torch import zoo as Z

        zoo, small = (Z.init_micro_zoo if args.micro else Z.init_tiny_zoo)(0, device)
        return HairFast(dataclasses.replace(small, compute_dtype="float32"), zoo=zoo,
                        device=device)
    return HairFast(cfg or config_from_args(args), device=device)


def main(args: argparse.Namespace) -> None:
    hair_fast = build(args)
    if args.file_path is not None:
        with open(args.file_path) as f:
            experiments = [tuple(line.split()) for line in f if line.strip()]
    else:
        experiments = [(args.face_path, args.shape_path, args.color_path)]
    args.output_dir.mkdir(parents=True, exist_ok=True)

    def name(exp) -> str:
        return "_".join(Path(p).stem for p in exp)

    if args.batch > 1:
        up = hair_fast._upload_res(args.upload_res)
        aligned: dict = {}

        def load(p):  # align once per unique photo, then reuse
            if not args.align:
                return to_image_u8(p, up)
            if p not in aligned:
                aligned[p] = to_image_u8(hair_fast._align([p])[0], up)
            return aligned[p]

        groups: dict = {}
        for exp in experiments:
            groups.setdefault(triple_case(*exp), []).append(exp)
        for case, exps in groups.items():
            for i in range(0, len(exps), args.batch):
                chunk = exps[i:i + args.batch]
                faces, shapes, colors = (np.stack([load(args.input_dir / e[j]) for e in chunk])
                                         for j in range(3))
                outs = hair_fast.swap_batch(faces, shapes, colors, case=case, output="uint8")
                for exp, out in zip(chunk, outs):
                    save_image01(args.output_dir / f"{name(exp)}.png", out)
        return

    for exp in experiments:
        face, shape, color = (args.input_dir / p for p in exp)
        out = hair_fast.swap(face, shape, color, benchmark=args.benchmark, align=args.align,
                             poisson=args.poisson, output="uint8", upload_res=args.upload_res,
                             output_res=args.output_res, exp_name=name(exp))
        save_image01(args.output_dir / f"{name(exp)}.png", out)
    if args.benchmark:
        hair_fast.bench.report()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HairFast runner (PyTorch port)",
                                parents=[get_parser()], add_help=False)
    p.add_argument("--input_dir", type=Path, default=Path(""))
    p.add_argument("--face_path", type=Path, default=None)
    p.add_argument("--shape_path", type=Path, default=None)
    p.add_argument("--color_path", type=Path, default=None)
    p.add_argument("--file_path", type=Path, default=None)
    p.add_argument("--output_dir", type=Path, default=Path("output"))
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--batch", type=int, default=1, help="triples per swap_batch call")
    p.add_argument("--tiny", action="store_true", help="128^2 random-weight config")
    p.add_argument("--micro", action="store_true",
                   help="--tiny with 0.25x trunk widths (the cheapest smoke run)")
    p.add_argument("--align", action="store_true",
                   help="FFHQ-align in-the-wild photos first (STAR when the zoo has it, "
                        "else dlib)")
    p.add_argument("--upload_res", type=int, default=None,
                   help="ship inputs at this resolution (e.g. 512; floor 512 on full-size "
                        "configs)")
    p.add_argument("--output_res", type=int, default=None,
                   help="serve the result at this resolution (snaps up to a power-of-two "
                        "divisor of size)")
    p.add_argument("--poisson", action="store_true",
                   help="Poisson-composite the original photo back outside the hair region")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises when no GPU is there)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
