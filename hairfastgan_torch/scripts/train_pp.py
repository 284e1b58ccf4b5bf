"""PostProcess encoder training CLI (counterpart of the JAX package's
scripts/train_pp.py; reference scripts/pp_train.py).

Data: .npz rows from gen_pp_data (source/target/target_mask/HT_E and the
full-res source_full, train/pp.py). Trains the PostProcess encoder with the
LossBuilderMulti objective; optional adversarial phase (--use_adv,
--iter_before) with a discriminator step per encoder step and R1 logged
every --d_reg_every steps; alpha annealing of the F injection
(pp_train.py:133-137: alpha = min(1, step * alpha_rate)).

Per-epoch validation on a held-out split (pp_train.py:185-232): the loss
terms at alpha=1 without the adversarial term, FID-CLIP of the F-path
renders against --fid_real_dir, [source|target|gen_W|gen_F] grids, and
best/last train states (the discriminator included).

    python -m hairfastgan_torch.scripts.train_pp --data_dir pp_rows --use_adv
    python -m hairfastgan_torch.scripts.train_pp --micro --device cpu --data_dir pp_rows \
        --epochs 1 --batch_size 2 --use_adv --iter_before 1 --d_reg_every 1

Every step, the discriminator's and R1 included, and the validation run on
a data mesh of the local devices (parallel/mesh.data_mesh_for_batch: the
largest divisor of --batch_size that fits them). --device defaults to cuda
and raises without a GPU; with cuda the mesh spans every visible GPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from hairfastgan_torch.scripts import batches, device_from_arg
from hairfastgan_torch.scripts.train_blending import load_rows

BATCH_KEYS = ("source", "target", "target_mask", "HT_E")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=Path, required=True)
    ap.add_argument("--ckpt_dir", type=Path, default=Path("checkpoints/pp"))
    ap.add_argument("--zoo_dir", type=Path, default=Path("pretrained_models_jax"))
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--use_adv", action="store_true")
    ap.add_argument("--split_compile", action="store_true",
                    help="run the encoder step as 3-4 segments (grad of a sum = sum of "
                         "grads), one segment's graph alive at a time: a lower peak of "
                         "device memory for ~2x the forward work; the same update")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each generator render in the backward pass "
                         "(torch.utils.checkpoint) instead of keeping its activations")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 activations and frozen nets (kept resident "
                         "in bf16), f32 Adam masters")
    ap.add_argument("--disc_pkl", type=Path, default=None,
                    help="NVlabs ffhq.pkl to start the adversarial phase from the "
                         "pretrained D (reference pp_train.py:59-63); defaults to "
                         "<torch_dir>/StyleGAN/ffhq.pkl if present")
    ap.add_argument("--torch_dir", type=Path, default=Path("pretrained_models"),
                    help="reference pretrained_models/ tree (for ffhq.pkl)")
    ap.add_argument("--iter_before", type=int, default=0,
                    help="steps before the adversarial term kicks in")
    ap.add_argument("--d_reg_every", type=int, default=16)
    ap.add_argument("--alpha_rate", type=float, default=1e-4)
    ap.add_argument("--resume", type=Path, default=None,
                    help="train-state dir to resume from (params, optimizer state, step "
                         "and, with --use_adv, the discriminator; pp_train.py:114-119)")
    ap.add_argument("--test_frac", type=float, default=0.1)
    ap.add_argument("--fid_cache", type=Path, default=None,
                    help="npz cache of the real-dir CLIP stats across runs "
                         "(reference input/fid.pkl, utils/train.py:125-161)")
    ap.add_argument("--fid_real_dir", type=Path, default=None,
                    help="real-face dir for per-validation FID-CLIP (pp_train.py:221)")
    ap.add_argument("--grid_dir", type=Path, default=None,
                    help="dump [source|target|gen_W|gen_F] validation grids")
    ap.add_argument("--log", type=Path, default=Path("pp_train.jsonl"))
    ap.add_argument("--tiny", action="store_true",
                    help="128-res random-weight config (CI smoke runs)")
    ap.add_argument("--micro", action="store_true",
                    help="128-res config with 0.25x trunk widths (zoo.init_micro_zoo): the "
                         "CLI's plumbing at a fraction of --tiny's CPU cost")
    ap.add_argument("--device", default="cuda")
    return ap


def _copy_into(tree, saved) -> None:
    """Load a saved tree's tensors into `tree`'s leaves in place (the
    optimizer holds those tensors)."""
    from hairfastgan_torch.train.common import tensor_leaves

    with torch.no_grad():
        for t, s in zip(tensor_leaves(tree), tensor_leaves(saved), strict=True):
            t.copy_(s)


def _01(x: torch.Tensor) -> np.ndarray:
    """[-1,1] NHWC tensor -> [0,1] float32 numpy."""
    return ((x.float() + 1) / 2).clamp(0, 1).cpu().numpy()


def main(argv=None):
    args = parser().parse_args(argv)
    device = device_from_arg(args.device)

    from hairfastgan_torch import zoo as Z
    from hairfastgan_torch.config import HairFastConfig
    from hairfastgan_torch.ops.resample import resize
    from hairfastgan_torch.parallel import mesh
    from hairfastgan_torch.params.checkpoint import restore_train_state, save_train_state
    from hairfastgan_torch.train.common import MetricLogger, check_finite_loss
    from hairfastgan_torch.train.pp import (make_pp_split_train_step, make_pp_train_steps,
                                            pp_loss)

    trunk_width = 0.25 if args.micro else 1.0  # loss nets at the micro zoo's scale
    if args.micro or args.tiny:
        zoo, cfg = (Z.init_micro_zoo if args.micro else Z.init_tiny_zoo)(0, device)
    else:
        cfg = HairFastConfig()
        zoo = (Z.load_zoo(args.zoo_dir, cfg, device) if args.zoo_dir.exists()
               else Z.init_zoo(cfg, seed=0, device=device))
    # frozen loss nets: BiSeNet-16 (seg.pth), IR-SE-50 id, LPIPS-alex, drawn
    # at random as the JAX CLI draws them
    frozen = Z.pp_train_frozen(zoo["generator"], trunk_width, seed=0, device=device)
    params, clip = zoo["post_process"], zoo["blending"]["clip"]
    del zoo

    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.bf16:
        # the frozen nets stay RESIDENT in bf16 (the in-loss cast would
        # otherwise hold both copies live)
        frozen = Z.cast_zoo(frozen, torch.bfloat16)
    # the data mesh is capped at the batch size (shard_batch needs
    # divisibility); it warns when devices are left idle
    plan = mesh.data_mesh_for_batch(args.batch_size, mesh.local_devices(device))
    frozen = mesh.replicate(plan, frozen)
    enc_step, disc_step, r1_step, tx, d_tx = make_pp_train_steps(
        frozen, cfg=cfg, lr=args.lr, use_adv=args.use_adv, remat=args.remat,
        compute_dtype=compute_dtype, plan=plan)
    if args.split_compile:
        enc_step, tx = make_pp_split_train_step(
            frozen, cfg=cfg, lr=args.lr, use_adv=args.use_adv, remat=args.remat,
            compute_dtype=compute_dtype, plan=plan)
    opt = tx.init(params)

    disc_params = d_opt = None
    if args.use_adv:
        pkl = args.disc_pkl or (args.torch_dir / "StyleGAN" / "ffhq.pkl")
        if pkl.exists():
            from hairfastgan_torch.params.bridge import map_tree
            from hairfastgan_torch.params.nvlabs import load_nvlabs_discriminator

            disc_params = map_tree(load_nvlabs_discriminator(str(pkl), size=cfg.stylegan.size),
                                   lambda _, t: t.to(device))
            print(f"adversarial phase starts from pretrained D: {pkl}")
        else:
            disc_params = Z.init_discriminator(cfg.stylegan, seed=0, device=device)
            print(f"WARNING: {pkl} not found; adversarial phase starts from a RANDOM "
                  "discriminator (the reference uses the pretrained ffhq.pkl D, "
                  "pp_train.py:59-63)")
        d_opt = d_tx.init(disc_params)

    rows = load_rows(args.data_dir)
    n_val = max(1, int(len(rows) * args.test_frac))
    val_rows, rows = rows[:n_val], rows[n_val:]

    # adversarial reals: the FULL-RES source (reference pp_train.py:125,162
    # feeds source_1024 to D and R1). Rows from gen_pp_data carry it as
    # 'source_full'; older rows without it fall back to upsampling the 256
    # source (a blurrier distribution: regenerate the data if possible).
    train_keys = BATCH_KEYS
    upsample_reals = False
    if args.use_adv and rows:
        with np.load(rows[0]) as z:
            has_full = "source_full" in z.files
        if has_full:
            train_keys = BATCH_KEYS + ("source_full",)
        else:
            upsample_reals = True
            print("WARNING: rows lack 'source_full'; adversarial reals are the 256 sources "
                  "upsampled to generator res; regenerate with gen_pp_data for true "
                  "full-res reals")

    logger = MetricLogger(str(args.log))
    step_i = 0
    best = float("inf")

    fid_real = feat_fn = None
    if args.fid_real_dir is not None:
        from hairfastgan_torch.eval.fid import clip_feature_fn
        from hairfastgan_torch.scripts.fid_metric import real_stats

        feat_fn = clip_feature_fn(clip)
        fid_real = real_stats(args.fid_real_dir, feat_fn, size=256, cache=args.fid_cache)

    if args.resume is not None:
        state = restore_train_state(args.resume, device=device)
        _copy_into(params, state["params"])
        opt.load_state_dict(state["opt_state"])
        step_i = int(state["step"])
        if args.use_adv and "disc" in state:
            _copy_into(disc_params, state["disc"])
        print(f"resumed from {args.resume} at step {step_i}")

    def upsample(x):  # NHWC 256 -> NHWC at the generator's resolution
        size = cfg.stylegan.size
        return resize(x.permute(0, 3, 1, 2), (size, size), "bilinear").permute(0, 2, 3, 1)

    try:
        for epoch in range(args.epochs):
            for full in batches(rows, train_keys, args.batch_size, device, seed=epoch):
                batch, source_full = full[:4], (full[4] if len(full) > 4 else None)
                alpha = min(1.0, args.alpha_rate * step_i)
                if args.use_adv:
                    # warm-up passes disc=None: the adversarial term is left out
                    d = disc_params if step_i >= args.iter_before else None
                    params, opt, aux = enc_step(params, opt, *batch, d, alpha)
                else:
                    params, opt, aux = enc_step(params, opt, *batch, alpha)
                logger.log(**{k: v for k, v in aux.items() if v.ndim == 0})
                check_finite_loss(aux["loss"], step_i)

                if args.use_adv and step_i >= args.iter_before:
                    real = source_full if source_full is not None else upsample(batch[0])
                    disc_params, d_opt, d_aux = disc_step(disc_params, d_opt, real,
                                                          aux["gen_f"])
                    logger.log(disc_adv=float(d_aux["disc_adv"]),
                               disc_grad_norm=float(d_aux["grad_norm"]))
                    if step_i % args.d_reg_every == 0:
                        logger.log(r1=float(r1_step(disc_params, real)))
                step_i += 1

            # per-epoch validation (pp_train.py:185-232)
            v_totals, v_terms, gen_f_all, grid_rows = [], {}, [], []
            with torch.no_grad():
                for b in batches(val_rows, BATCH_KEYS, args.batch_size, device, shuffle=False):
                    total, aux = pp_loss(params, frozen, b, alpha=1.0, cfg=cfg, plan=plan)
                    v_totals.append(float(total))
                    for k, v in aux.items():
                        if v.ndim == 0:
                            v_terms.setdefault(k, []).append(float(v))
                    gf = _01(aux["gen_f_256"])
                    gen_f_all.append(gf)
                    if args.grid_dir is not None:
                        grid_rows.append(np.concatenate(
                            [_01(b[0]), _01(b[1]), _01(aux["gen_w_256"]), gf], axis=2))
            v = float(np.mean(v_totals)) if v_totals else float("nan")
            logger.log(val_loss=v, **{f"val_{k}": float(np.mean(vs))
                                      for k, vs in v_terms.items()})

            extra = ""
            if feat_fn is not None and gen_f_all:
                from hairfastgan_torch.eval.fid import fid_to

                fid = fid_to(fid_real, np.concatenate(gen_f_all), feat_fn)
                logger.log(fid_clip=fid)
                extra = f" fid-clip {fid:.3f}"
            if args.grid_dir is not None and grid_rows:
                from hairfastgan_torch.utils.images import save_image01
                from hairfastgan_torch.utils.save_utils import image_grid

                save_image01(args.grid_dir / f"epoch_{epoch:04d}.png",
                             image_grid(np.concatenate(grid_rows)[:100]))

            print(f"epoch {epoch}: val {v:.4f}{extra} ({step_i} steps)")
            save_train_state(args.ckpt_dir / "last", params, opt.state_dict(), step_i,
                             disc_params=disc_params)
            if v < best:
                best = v
                save_train_state(args.ckpt_dir / "best", params, opt.state_dict(), step_i,
                                 disc_params=disc_params)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
