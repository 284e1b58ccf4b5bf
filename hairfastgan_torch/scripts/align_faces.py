"""Batch FFHQ-style face alignment (counterpart of the JAX package's
scripts/align_faces.py; reference scripts/align_face.py):

    python -m hairfastgan_torch.scripts.align_faces --input_dir photos \
        --output_dir aligned [--zoo_dir DIR] [--dlib] [--device cpu]

Crops in-the-wild photos to the 1024^2 FFHQ frame the pipeline expects
(utils/face_align.py). Landmark provider: the STAR model on --device when
<zoo_dir>/star_wflw.pth exists (no dlib needed), else dlib + the
shape_predictor_68 model; fails loudly when neither is available. --device
defaults to cuda and raises without a GPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from hairfastgan_torch.scripts import device_from_arg, image_files


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_dir", type=Path, required=True)
    ap.add_argument("--output_dir", type=Path, required=True)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--dlib", action="store_true",
                    help="force the dlib provider even when the STAR checkpoint is present "
                         "(reference-exact landmarks)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch.models import star
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.params.convert import load_torch_state_dict
    from hairfastgan_torch.utils.face_align import align_faces
    from hairfastgan_torch.utils.images import save_image01, to_raw_image

    star_p = None
    star_ckpt = args.zoo_dir / "star_wflw.pth"
    if star_ckpt.exists() and not args.dlib:
        star_p = map_tree(star.convert_star(load_torch_state_dict(star_ckpt, key="net")),
                          lambda _, t: t.to(device))
        print(f"landmarks: STAR (on {device})")

    args.output_dir.mkdir(parents=True, exist_ok=True)
    for p in image_files(args.input_dir):
        aligned = align_faces([to_raw_image(p)], output_size=args.size, star_params=star_p)[0]
        save_image01(args.output_dir / f"{p.stem}.png", aligned)
        print(p.name)


if __name__ == "__main__":
    main()
