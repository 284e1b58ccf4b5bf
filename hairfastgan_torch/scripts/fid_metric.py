"""FID / FID-CLIP evaluation CLI (counterpart of the JAX package's
scripts/fid_metric.py):

    python -m hairfastgan_torch.scripts.fid_metric --real_dir real \
        --method_dirs ours theirs [--inception_ckpt inception_v3.pth] [--device cpu]

Compares each method directory against a real-face directory and, like the
reference (`scripts/fid_metric.py:62-72`), writes both metric columns in
one run: classic FID over InceptionV3 pool3 features (`--inception_ckpt`, a
torchvision inception_v3 state_dict converted by
models/inception.convert_inception) and FID-CLIP over CLIP ViT-B/32
embeddings (utils/train.py:125-161). Without `--inception_ckpt` only the
FID-CLIP column is written (random Inception weights would make the FID
number meaningless). The CLIP tower is the zoo's (`zoo.load_zoo` of
--zoo_dir) or, without one, a random tower from seed 0.

`load_dir` and `real_stats` are shared with the trainers' per-epoch
FID-CLIP validation.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.scripts import device_from_arg, image_files


def load_dir(d: Path, size: int = 299, limit: int = 0) -> np.ndarray:
    """The .png/.jpg/.jpeg images of `d` in name order -> [N,size,size,3]
    float32 in [0,1]: the port's native loader when it builds, else PIL."""
    from hairfastgan_torch.data.native_loader import NativeImageLoader, native_available
    from hairfastgan_torch.utils.images import to_image_array

    paths = image_files(d)
    if limit:
        paths = paths[:limit]
    if native_available():
        out = np.empty((len(paths), size, size, 3), np.float32)
        with NativeImageLoader(paths, out_size=size, threads=4, dtype=np.float32) as loader:
            for i, img in loader:
                out[i] = img
        return out
    return np.stack([to_image_array(p, size) for p in paths])


def real_stats(real_dir: Path, feat_fn, cache: Path = None, size: int = 299,
               batch: int = 64, limit: int = 0):
    """(mu, cov) of a real-image dir through feat_fn, npz-cached across runs
    (the reference caches real-dataset FID stats in input/fid.pkl,
    utils/train.py:125-161): re-featurizing thousands of images every
    training run is the expensive part."""
    from hairfastgan_torch.eval.fid import FIDStats

    if cache is not None and Path(cache).exists():
        return FIDStats.load(cache).finalize()
    imgs = load_dir(real_dir, size=size, limit=limit)
    s = FIDStats()
    for i in range(0, len(imgs), batch):
        s.update(feat_fn(imgs[i:i + batch]))
    if cache is not None:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        s.save(cache)
    return s.finalize()


def load_inception_feature_fn(ckpt: Path, device="cpu"):
    """torchvision inception_v3 state_dict file -> pool3 feature fn on `device`."""
    from hairfastgan_torch.eval.fid import inception_feature_fn
    from hairfastgan_torch.models.inception import convert_inception
    from hairfastgan_torch.params.bridge import map_tree

    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "Conv2d_1a_3x3.conv.weight" not in sd:
        sd = sd.get("state_dict", sd)
    sd = {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in sd.items()}
    return inception_feature_fn(map_tree(convert_inception(sd), lambda _, t: t.to(device)))


def _feature_cache(base: Path, name: str) -> Path:
    """Per-feature-net real-stats cache path (the two nets' stats are
    different arrays; a shared file would silently mix them)."""
    if base is None:
        return None
    return base.with_name(f"{base.stem}_{name}{base.suffix or '.npz'}")


def clip_tower(zoo_dir: Path, device) -> dict:
    """The zoo's CLIP image tower (zoo.load_zoo of `zoo_dir`, memory-mapped
    for a zoo_torch.pt), or a random full-width tower from seed 0 when the
    directory does not exist; on `device`."""
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.models import clip_vit
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.zoo import fill_random, load_zoo

    if zoo_dir.exists():
        clip = load_zoo(zoo_dir, HairFastConfig())["blending"]["clip"]
        return map_tree(clip, lambda _, t: t.to(device))
    return fill_random(clip_vit.init_clip_image_tower(), 0, device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real_dir", type=Path, required=True)
    ap.add_argument("--method_dirs", type=Path, nargs="+", required=True)
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--inception_ckpt", type=Path, default=None,
                    help="torchvision inception_v3 state_dict (.pth); adds the classic-FID "
                         "column like the reference scripts/fid_metric.py:62-66")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--size", type=int, default=299,
                    help="feature-net input resolution (reference loads at 299, "
                         "fid_metric.py:19; smaller is useful in tests)")
    ap.add_argument("--fid_cache", type=Path, default=None,
                    help="base path for npz caches of the real-dir stats, suffixed per "
                         "feature net (reference input/fid.pkl analog)")
    ap.add_argument("--out_csv", type=Path, default=Path("fid_results.csv"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch.eval.fid import FIDStats, clip_feature_fn, frechet_distance

    # column order mirrors the reference CSV: FID first, then FID_CLIP
    feats = []
    if args.inception_ckpt is not None:
        feats.append(("fid", load_inception_feature_fn(args.inception_ckpt, device)))
    feats.append(("fid_clip", clip_feature_fn(clip_tower(args.zoo_dir, device))))

    stats_r = {name: real_stats(args.real_dir, fn, cache=_feature_cache(args.fid_cache, name),
                                size=args.size, batch=args.batch, limit=args.limit)
               for name, fn in feats}

    lines = ["method," + ",".join(name for name, _ in feats)]
    for md in args.method_dirs:
        fake = load_dir(md, size=args.size, limit=args.limit)
        row = []
        for name, fn in feats:
            sf = FIDStats()
            for i in range(0, len(fake), args.batch):
                sf.update(fn(fake[i:i + args.batch]))
            d = frechet_distance(*stats_r[name], *sf.finalize())
            row.append(d)
            print(f"{md.name}: {name.upper().replace('_', '-')} {d:.4f}")
        lines.append(md.name + "," + ",".join(f"{d:.6f}" for d in row))
    args.out_csv.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
