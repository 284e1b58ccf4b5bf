"""Convert the reference's pretrained_models/ into the port's zoo file.

    python -m hairfastgan_torch.convert_checkpoints --torch_dir pretrained_models \
        --out_dir pretrained_models_jax

Runs every converter of params/convert.py through zoo.load_zoo on the CPU
and writes OUT_DIR/zoo_torch.pt (params/checkpoint.save_zoo), which
`HairFast(cfg)` with `checkpoint_dir=OUT_DIR` (the CLI's --ckpt_dir, the
server's --zoo_dir) then loads memory-mapped instead of converting again.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.params.bridge import map_tree
from hairfastgan_torch.params.checkpoint import save_zoo
from hairfastgan_torch.zoo import load_zoo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--torch_dir", type=Path, required=True,
                    help="the reference's pretrained_models/ tree")
    ap.add_argument("--out_dir", type=Path, required=True)
    args = ap.parse_args(argv)
    zoo = load_zoo(args.torch_dir, HairFastConfig(), device="cpu")
    sizes = []
    map_tree(zoo, lambda _, t: sizes.append(t.numel()))
    path = save_zoo(args.out_dir, zoo)
    print(f"converted zoo: {sum(sizes)} parameters -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
