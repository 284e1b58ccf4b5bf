"""FID-CLIP helpers of the evaluation CLI (counterpart of the JAX package's
scripts/fid_metric.py): `load_dir` reads an image directory, `real_stats`
featurizes it once and caches the statistics in an npz across runs. The
trainers' per-epoch FID-CLIP validation reads both. The CLI's `main` (with
classic FID over InceptionV3) comes with models/inception.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hairfastgan_torch.scripts import image_files


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
