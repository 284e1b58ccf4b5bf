"""Blending (color) encoder training CLI (counterpart of the JAX package's
scripts/train_blending.py; reference scripts/blending_train.py).

Data: a directory of .npz rows written by gen_blending_data (the
Blending_dataset layout, train/blending.py). Trains the blending encoder's
ModulationModule stack with Adam(1e-4) + clip(5) on a data mesh of the
local devices (parallel/mesh.data_mesh_for_batch: the largest divisor of
--batch_size that fits them); validates with the held-out loss over the
same mesh; keeps best/last train states (params/checkpoint.save_train_state,
CLIP stripped) and a jsonl log.

    python -m hairfastgan_torch.scripts.train_blending --data_dir blend_rows
    python -m hairfastgan_torch.scripts.train_blending --tiny --device cpu \
        --data_dir blend_rows --epochs 1 --batch_size 2

--device defaults to cuda and raises without a GPU; with --device cuda the
mesh spans every visible GPU. --fid_real_dir adds FID-CLIP of the
validation renders against a real-face directory to each epoch's log
(eval/fid.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.scripts import batches, device_from_arg

BATCH_KEYS = ("color_s", "align_s", "align_f", "color_i", "face_i",
              "target_mask", "HM_3E", "HM_XE")


def load_rows(data_dir: Path):
    rows = sorted(Path(data_dir).glob("*.npz"))
    if not rows:
        raise FileNotFoundError(f"no .npz rows in {data_dir}")
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=Path, required=True)
    ap.add_argument("--ckpt_dir", type=Path, default=Path("checkpoints/blending"))
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--test_frac", type=float, default=0.1)
    ap.add_argument("--fid_cache", type=Path, default=None,
                    help="npz cache of the real-dir CLIP stats across runs "
                         "(reference input/fid.pkl, utils/train.py:125-161)")
    ap.add_argument("--fid_real_dir", type=Path, default=None,
                    help="real-face dir for per-validation FID-CLIP "
                         "(blending_train.py:127-167)")
    ap.add_argument("--grid_dir", type=Path, default=None,
                    help="dump validation render grids here")
    ap.add_argument("--log", type=Path, default=Path("blending_train.jsonl"))
    ap.add_argument("--tiny", action="store_true",
                    help="128-res random-weight config (CI smoke runs); align_f rows stay "
                         "32x32x512: the FS interface is structural")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.parallel import mesh
    from hairfastgan_torch.params.checkpoint import save_train_state
    from hairfastgan_torch.train.blending import (blend_render, blending_loss,
                                                  make_blending_train_step)
    from hairfastgan_torch.train.common import MetricLogger, check_finite_loss, shard_loss

    if args.tiny:
        frozen, params, cfg = Z.blending_train_tiny(0, device)
    else:
        cfg = HairFastConfig()
        zoo = (Z.load_zoo(args.zoo_dir, cfg, device) if args.zoo_dir.exists()
               else Z.init_zoo(cfg, seed=0, device=device))
        frozen = {"generator": zoo["generator"], "clip": zoo["blending"]["clip"]}
        params = {"mods": zoo["blending"]["mods"]}

    # the data mesh is capped at the batch size (shard_batch needs
    # divisibility); it warns when devices are left idle
    plan = mesh.data_mesh_for_batch(args.batch_size, mesh.local_devices(device))
    frozen_reps = mesh.replicate(plan, frozen)
    step, tx = make_blending_train_step(frozen_reps, cfg, lr=args.lr, plan=plan)
    val_loss = shard_loss(plan, lambda p, fr, *b: blending_loss(p, fr, b, cfg))
    opt = tx.init(params)

    rows = load_rows(args.data_dir)
    n_test = max(1, int(len(rows) * args.test_frac))
    test_rows, train_rows = rows[:n_test], rows[n_test:]
    logger = MetricLogger(str(args.log))
    best = float("inf")

    feat_fn = None
    if args.fid_real_dir is not None:
        from hairfastgan_torch.eval.fid import clip_feature_fn
        from hairfastgan_torch.scripts.fid_metric import real_stats

        feat_fn = clip_feature_fn(frozen["clip"])
        fid_real = real_stats(args.fid_real_dir, feat_fn, size=256, cache=args.fid_cache)

    try:
        for epoch in range(args.epochs):
            for batch in batches(train_rows, BATCH_KEYS, args.batch_size, device, seed=epoch):
                params, opt, aux = step(params, opt, *batch)
                logger.log(loss=aux["loss"], face=aux["face_loss"], hair=aux["hair_loss"],
                           grad=aux["grad_norm"])
                check_finite_loss(aux["loss"], logger.step)

            with torch.no_grad():
                vls = [float(val_loss(params, frozen_reps, *b)[0])
                       for b in batches(test_rows, BATCH_KEYS, args.batch_size, device,
                                        shuffle=False)]
            v = float(np.mean(vls)) if vls else float("nan")
            logger.log(val_loss=v)

            extra = ""
            if feat_fn is not None or args.grid_dir is not None:
                with torch.no_grad():
                    renders = [((blend_render(params, frozen, *b[:7], cfg) + 1) / 2)
                               .clamp(0, 1).permute(0, 2, 3, 1).cpu().numpy()
                               for b in batches(test_rows, BATCH_KEYS, args.batch_size, device,
                                                shuffle=False)]
                if renders:
                    renders = np.concatenate(renders)
                    if feat_fn is not None:
                        from hairfastgan_torch.eval.fid import fid_to

                        fid = fid_to(fid_real, renders, feat_fn)
                        logger.log(fid_clip=fid)
                        extra += f" fid-clip {fid:.3f}"
                    if args.grid_dir is not None:
                        from hairfastgan_torch.utils.images import save_image01
                        from hairfastgan_torch.utils.save_utils import image_grid

                        save_image01(args.grid_dir / f"epoch_{epoch:04d}.png",
                                     image_grid(renders[:100]))
            print(f"epoch {epoch}: val {v:.4f}{extra}")
            save_train_state(args.ckpt_dir / "last", params, opt.state_dict(), logger.step)
            if v < best:
                best = v
                save_train_state(args.ckpt_dir / "best", params, opt.state_dict(), logger.step)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
