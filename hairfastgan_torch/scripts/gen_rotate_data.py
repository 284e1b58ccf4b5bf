"""Rotate-dataset generation (counterpart of the JAX package's
scripts/gen_rotate_data.py; reference scripts/rotate_gen.py).

The reference precomputes, per FFHQ image, the 256 target, its e4e W+ code
and its STAR keypoints, then pairs rows randomly at train time. The trainer
(scripts/train_rotate.py) reads pre-paired .npz rows, so this generator
pairs up front:

  pose rows (pose_dir): I_from [1,256,256,3] in [0,1], kp_to [1,76,2] (STAR
                        landmarks of the TARGET image), W_from, W_to
  hair rows (hair_dir): W_from = cat(W_to_pose[:6], W_src[6:]), W_to =
                        W_src: the data-level analog of the reference's
                        cycle pairs (rotate_train.py:205-216); rotating
                        W_from back toward W_src must recover W_src[:6].

    python -m hairfastgan_torch.scripts.gen_rotate_data --input_dir imgs \
        --n_pairs 10000 --pose_dir pose --hair_dir hair
    python -m hairfastgan_torch.scripts.gen_rotate_data --micro --device cpu \
        --no_keypoints --input_dir imgs --n_pairs 4 --pose_dir pose --hair_dir hair

Keypoints come from the zoo's STAR weights (zoo["star"], which zoo.load_zoo
reads from star_wflw.pth in --zoo_dir; with --tiny/--micro from that file
alone). Without them --no_keypoints must be explicit: it writes zero
keypoints, and train_rotate must then also run with --no_keypoints.
--device defaults to cuda and raises without a GPU.
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
    ap.add_argument("--n_pairs", type=int, default=10_000)
    ap.add_argument("--pose_dir", type=Path, required=True)
    ap.add_argument("--hair_dir", type=Path, required=True)
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--seed", type=int, default=3407)
    ap.add_argument("--no_keypoints", action="store_true",
                    help="emit zero keypoints (no STAR checkpoint); the trainer must then "
                         "also run with --no_keypoints")
    ap.add_argument("--tiny", action="store_true",
                    help="128-res random-weight config (CI smoke runs)")
    ap.add_argument("--micro", action="store_true",
                    help="--tiny with 0.25x trunk widths (cheapest CI smoke; W rows stay "
                         "[n_latent, 512]: the style dim is width-independent)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.models import star
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.params.convert import load_torch_state_dict
    from hairfastgan_torch.train.datagen import generate_rotate_pair
    from hairfastgan_torch.utils.images import to_image_array

    if args.micro or args.tiny:
        zoo, cfg = (Z.init_micro_zoo if args.micro else Z.init_tiny_zoo)(0, device)
    else:
        cfg = HairFastConfig()
        zoo = (Z.load_zoo(args.zoo_dir, cfg, device) if args.zoo_dir.exists()
               else Z.init_zoo(cfg, seed=0, device=device))

    star_ckpt = args.zoo_dir / "star_wflw.pth"
    star_p = zoo.get("star")
    if star_p is None and star_ckpt.exists():
        star_p = map_tree(star.convert_star(load_torch_state_dict(star_ckpt, key="net")),
                          lambda _, t: t.to(device))
    if star_p is not None:
        def keypoint_fn(img):
            return star.keypoints_256(star_p, img)
    elif args.no_keypoints:
        print("WARNING: --no_keypoints: pose rows carry ZERO keypoints")

        def keypoint_fn(img):
            return img.new_zeros((img.shape[0], 76, 2))
    else:
        raise SystemExit(
            f"STAR checkpoint not found: {star_ckpt}\n"
            "Rotate data needs the landmark extractor for kp_to. Either place "
            "star_wflw.pth in --zoo_dir, or pass --no_keypoints.")

    files = image_files(args.input_dir)
    if len(files) < 2:
        raise SystemExit(f"need >=2 images in {args.input_dir}")
    rng = random.Random(args.seed)
    pairs = [tuple(rng.sample(files, 2)) for _ in range(args.n_pairs)]

    args.pose_dir.mkdir(parents=True, exist_ok=True)
    args.hair_dir.mkdir(parents=True, exist_ok=True)
    for i, (a, b) in enumerate(pairs):
        imgs = [torch.from_numpy(to_image_array(p, cfg.stylegan.size))[None].to(device)
                for p in (a, b)]
        with torch.no_grad():
            row = generate_rotate_pair(zoo, *imgs, cfg)
            row["kp_to"] = keypoint_fn(row.pop("I_to"))
        row = {k: v.float().cpu().numpy() for k, v in row.items()}
        np.savez(args.pose_dir / f"row_{i:06d}.npz", I_from=row["I_from"], kp_to=row["kp_to"],
                 W_from=row["W_from"], W_to=row["W_to"])
        # cycle hair pair: pose rows of the target grafted onto the source
        w_mix = np.concatenate([row["W_to"][:, :6], row["W_from"][:, 6:]], axis=1)
        np.savez(args.hair_dir / f"row_{i:06d}.npz", W_from=w_mix, W_to=row["W_from"])
        if i % 50 == 0:
            print(f"{i}/{len(pairs)}")


if __name__ == "__main__":
    main()
