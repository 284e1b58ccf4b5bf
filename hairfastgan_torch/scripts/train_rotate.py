"""Rotate (pose) encoder training CLI (counterpart of the JAX package's
scripts/train_rotate.py; reference scripts/rotate_train.py).

Alternates pose-pair batches (keypoint MSE + ArcFace identity) with
same-person hair-pair batches (latent MSE), EMA-balanced like the
reference's MovingAverageLoss (normalize=True in training, raw sums in
validation, rotate_train.py:155-158,233-282), on a data mesh of the local
devices (parallel/mesh.data_mesh_for_batch). Per-epoch validation on a
held-out split, over the same mesh, keeps best/last train states and
optional render grids.

    python -m hairfastgan_torch.scripts.train_rotate --pose_dir pose --hair_dir hair
    python -m hairfastgan_torch.scripts.train_rotate --tiny --no_keypoints --device cpu \
        --pose_dir pose --hair_dir hair --epochs 1 --batch_size 2

The keypoint extractor is STAR (models/star.py) from star_wflw.pth in
--zoo_dir; without it the keypoint half of the objective is a constant, so
the script refuses to run unless --no_keypoints is passed. The ArcFace
IR-SE-50 backbone is drawn at random, as the JAX CLI draws it (neither
package loads an identity checkpoint for this trainer yet). --device
defaults to cuda and raises without a GPU; with cuda the mesh spans every
visible GPU.

Data rows (.npz): pose: I_from [1,256,256,3] [0,1], kp_to [1,76,2],
W_from/W_to [1,n_latent,512]; hair: W_from/W_to only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.scripts import batches, device_from_arg

POSE_KEYS = ("I_from", "kp_to", "W_from", "W_to")
HAIR_KEYS = ("W_from", "W_to")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pose_dir", type=Path, required=True)
    ap.add_argument("--hair_dir", type=Path, required=True)
    ap.add_argument("--ckpt_dir", type=Path, default=Path("checkpoints/rotate"))
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--test_frac", type=float, default=0.1)
    ap.add_argument("--grid_dir", type=Path, default=None,
                    help="dump [I_from | rotated render] validation grids")
    ap.add_argument("--no_keypoints", action="store_true",
                    help="train WITHOUT the keypoint loss (no STAR checkpoint). Must be "
                         "explicit: half the pose objective becomes a constant.")
    ap.add_argument("--log", type=Path, default=Path("rotate_train.jsonl"))
    ap.add_argument("--tiny", action="store_true",
                    help="128-res random-weight config (CI smoke runs)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.models import star
    from hairfastgan_torch.parallel import mesh
    from hairfastgan_torch.params.bridge import map_tree
    from hairfastgan_torch.params.checkpoint import save_train_state
    from hairfastgan_torch.params.convert import load_torch_state_dict
    from hairfastgan_torch.train.common import (MetricLogger, MovingAverageLoss,
                                                check_finite_loss, shard_loss)
    from hairfastgan_torch.train.rotate import (make_rotate_train_steps, rotate_hair_loss,
                                                rotate_pose_loss, rotate_render)

    if args.tiny:
        frozen, params, cfg = Z.rotate_train_tiny(0, device)
    else:
        cfg = HairFastConfig()
        zoo = (Z.load_zoo(args.zoo_dir, cfg, device) if args.zoo_dir.exists()
               else Z.init_zoo(cfg, seed=0, device=device))
        frozen = {"generator": zoo["generator"], "arcface": Z.init_arcface(0, device)}
        params = zoo["rotate"]

    # STAR landmark extractor. A missing checkpoint is an ERROR unless
    # --no_keypoints: a zero extractor silently turns the keypoint MSE into
    # a parameter-independent constant.
    star_ckpt = args.zoo_dir / "star_wflw.pth"
    if star_ckpt.exists():
        frozen["star"] = map_tree(star.convert_star(load_torch_state_dict(star_ckpt, key="net")),
                                  lambda _, t: t.to(device))

        def keypoint_fn(fr, img):
            return star.keypoints_256(fr["star"], img)
    elif args.no_keypoints:
        print("WARNING: --no_keypoints: pose batches train on the ArcFace identity loss "
              "only (keypoint MSE is a constant)")

        def keypoint_fn(fr, img):
            return img.new_zeros((img.shape[0], 76, 2))
    else:
        raise SystemExit(
            f"STAR checkpoint not found: {star_ckpt}\n"
            "Rotate training needs the landmark extractor for its keypoint loss. Either "
            "place star_wflw.pth in --zoo_dir, or pass --no_keypoints to train on the "
            "identity+latent losses only.")

    # the data mesh is capped at the batch size (shard_batch needs
    # divisibility); it warns when devices are left idle
    plan = mesh.data_mesh_for_batch(args.batch_size, mesh.local_devices(device))
    frozen_reps = mesh.replicate(plan, frozen)
    pose_step, hair_step, tx = make_rotate_train_steps(frozen_reps, keypoint_fn, cfg,
                                                       lr=args.lr, plan=plan)
    val_pose = shard_loss(plan, lambda p, fr, *b: rotate_pose_loss(p, fr, b, keypoint_fn, cfg))
    val_hair = shard_loss(plan, lambda p, *b: rotate_hair_loss(p, b))
    opt = tx.init(params)

    pose_rows = sorted(args.pose_dir.glob("*.npz"))
    hair_rows = sorted(args.hair_dir.glob("*.npz"))
    n_vp = max(1, int(len(pose_rows) * args.test_frac))
    n_vh = max(1, int(len(hair_rows) * args.test_frac))
    val_pose_rows, pose_rows = pose_rows[:n_vp], pose_rows[n_vp:]
    val_hair_rows, hair_rows = hair_rows[:n_vh], hair_rows[n_vh:]

    logger = MetricLogger(str(args.log))
    # rotate_train.py:98: EMA targets {'mse points to': 6, 'mse latents': 2}
    mal = MovingAverageLoss({"mse_points": 6.0, "mse_latents": 2.0})
    best = float("inf")

    def scalars(aux):
        return {k: float(v) for k, v in aux.items()}

    try:
        for epoch in range(args.epochs):
            pose_it = batches(pose_rows, POSE_KEYS, args.batch_size, device, seed=epoch)
            hair_it = batches(hair_rows, HAIR_KEYS, args.batch_size, device, seed=epoch)
            for pose_b, hair_b in zip(pose_it, hair_it):
                m = mal.multipliers(("mse_points", "arc_face"))
                params, opt, aux = pose_step(params, opt, *pose_b, m)
                s = scalars(aux)
                mal.update({k: s[k] for k in ("mse_points", "arc_face")})
                logger.log(**s)
                check_finite_loss(s["loss"], logger.step)

                m = mal.multipliers(("mse_latents",))
                params, opt, aux = hair_step(params, opt, *hair_b, m)
                s = scalars(aux)
                mal.update({"mse_latents": s["mse_latents"]})
                logger.log(**s)

            # per-epoch validation: raw loss sums over the held-out split
            vals = []
            with torch.no_grad():
                for b in batches(val_pose_rows, POSE_KEYS, args.batch_size, device,
                                 shuffle=False):
                    vals.append(scalars(val_pose(params, frozen_reps, *b)[1]))
                for b in batches(val_hair_rows, HAIR_KEYS, args.batch_size, device,
                                 shuffle=False):
                    vals.append({"mse_latents": float(val_hair(params, *b)[0])})
            agg = {}
            for d in vals:
                for k, v in d.items():
                    agg[k] = agg.get(k, 0.0) + v / max(1, sum(1 for e in vals if k in e))
            v_total = sum(agg.values())
            logger.log(**{f"val_{k}": v for k, v in agg.items()}, val_loss=v_total)

            if args.grid_dir is not None:
                from hairfastgan_torch.utils.images import save_image01
                from hairfastgan_torch.utils.save_utils import image_grid

                rows_imgs = []
                with torch.no_grad():
                    for b in batches(val_pose_rows, POSE_KEYS, args.batch_size, device,
                                     shuffle=False):
                        gen = rotate_render(params, frozen, b[2], b[3], cfg)
                        rows_imgs.append(torch.cat([b[0], gen], dim=2).cpu().numpy())
                        if sum(r.shape[0] for r in rows_imgs) >= 100:
                            break
                if rows_imgs:
                    save_image01(args.grid_dir / f"epoch_{epoch:04d}.png",
                                 image_grid(np.concatenate(rows_imgs)[:100]))

            print(f"epoch {epoch}: val {v_total:.4f}")
            save_train_state(args.ckpt_dir / "last", params, opt.state_dict(), logger.step)
            if v_total < best:
                best = v_total
                save_train_state(args.ckpt_dir / "best", params, opt.state_dict(), logger.step)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
