"""Intermediate dumps of the `save_all` mode (reference utils/save_utils.py:
12-38): per-stage images, mask visualizations in CtrlHair's colors, and
latent npz bundles under save_all_dir/<exp>/<stage>/."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hairfastgan_torch.utils.images import save_image01

# CtrlHair mask_to_rgb draw_type=0 table (mask_color_util.py:25-44): 19
# classes, and white for anything above (the 255 -> "unk" rule, by the clip)
PARSING_COLORS = np.array([
    [0, 128, 64], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [51, 255, 255], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0], [255, 255, 255],
], np.uint8)


def save_gen_image(out_dir: Path, stage: str, name: str, img) -> None:
    """[-1,1] NHWC/HWC image -> PNG (reference save_gen_image)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    save_image01(Path(out_dir) / stage / name, (arr + 1.0) / 2.0)


def save_vis_mask(out_dir: Path, stage: str, name: str, labels) -> None:
    """Integer label mask -> color PNG in the CtrlHair palette (mask_to_rgb)."""
    lab = np.asarray(labels)
    while lab.ndim > 2:
        lab = lab[0]
    rgb = PARSING_COLORS[np.clip(lab, 0, len(PARSING_COLORS) - 1)]
    save_image01(Path(out_dir) / stage / name, rgb.astype(np.float32) / 255.0)


def image_grid(images, cols: int = 10) -> np.ndarray:
    """Tile [N,H,W,3] [0,1] images into one grid image (the reference's
    validation grids, utils/train.py image_grid)."""
    arr = np.asarray(images)
    n, h, w, c = arr.shape
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), arr.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    return grid


def save_latents(out_dir: Path, stage: str, name: str, **latents) -> None:
    path = Path(out_dir) / stage / name
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in latents.items()})
