"""Blending-dataset generation (counterpart of the JAX package's
scripts/gen_blending_data.py; reference scripts/blending_gen.py).

Runs the inference pipeline up to (but not including) the blending encoder
on FFHQ-style triples and writes one .npz row per triple, with the keys
and shapes of train/datagen.generate_blending_sample.

    python -m hairfastgan_torch.scripts.gen_blending_data --input_dir imgs \
        --n_random 1000 --out_dir blend_rows
    python -m hairfastgan_torch.scripts.gen_blending_data --micro --device cpu \
        --input_dir imgs --n_random 4 --out_dir blend_rows

Input: --file_path with lines "face shape color" (paths relative to
--input_dir), or --n_random random triples drawn from --input_dir. The zoo
comes from --zoo_dir when it exists (zoo.load_zoo), else random weights.
--device defaults to cuda and raises without a GPU. --tiny and --micro
(not in the JAX script) run the CLI's 128^2 random zoos, for smoke runs.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.scripts import device_from_arg, image_files


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_dir", type=Path, required=True)
    ap.add_argument("--file_path", type=Path, default=None)
    ap.add_argument("--n_random", type=int, default=0)
    ap.add_argument("--out_dir", type=Path, required=True)
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--seed", type=int, default=3407)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="128^2 random tiny zoo: rows that the trainer's --tiny reads")
    ap.add_argument("--micro", action="store_true",
                    help="--tiny with 0.25x trunk widths and 128 generator channels "
                         "(cheapest CPU smoke; align_f rows have 128 channels)")
    return ap


def main(argv=None):
    from hairfastgan_torch.train.datagen import generate_blending_sample

    write_rows(parser().parse_args(argv), generate_blending_sample)


def write_rows(args, generate) -> None:
    """One .npz row of generate(zoo, face, shape, color, cfg) per triple of
    `args` (the parser above), the zoo and device as its flags say."""
    device = device_from_arg(args.device)

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.utils.images import to_image_array

    if args.micro or args.tiny:
        zoo, cfg = (Z.init_micro_zoo if args.micro else Z.init_tiny_zoo)(0, device)
    else:
        cfg = HairFastConfig()
        zoo = (Z.load_zoo(args.zoo_dir, cfg, device) if args.zoo_dir.exists()
               else Z.init_zoo(cfg, seed=0, device=device))

    triples = []
    if args.file_path:
        for line in open(args.file_path):
            if line.strip():
                triples.append(tuple(line.split()))
    else:
        files = [p.name for p in image_files(args.input_dir)]
        rng = random.Random(args.seed)
        for _ in range(args.n_random):
            triples.append(tuple(rng.sample(files, 3)))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    for i, triple in enumerate(triples):
        imgs = [torch.from_numpy(to_image_array(args.input_dir / p, cfg.stylegan.size))[None]
                .to(device) for p in triple]
        row = generate(zoo, *imgs, cfg)
        np.savez(args.out_dir / f"row_{i:06d}.npz",
                 **{k: v.float().cpu().numpy() for k, v in row.items()})
        if i % 50 == 0:
            print(f"{i}/{len(triples)}")

if __name__ == "__main__":
    main()
