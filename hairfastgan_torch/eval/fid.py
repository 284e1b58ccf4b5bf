"""FID / FID-CLIP evaluation (counterpart of hairfastgan_tpu/eval/fid.py).

Rebuilds the reference's quality harness (scripts/fid_metric.py:24-66,
utils/train.py:125-161): Frechet distance between gaussian fits of feature
distributions: InceptionV3 pool3 features for classic FID
(`inception_feature_fn`, models/inception) and CLIP ViT-B/32 image
embeddings for "FID-CLIP" (`clip_feature_fn`; ClipModel,
models/Encoders.py:140-160).

Feature extraction is pluggable (`feature_fn(images01) -> [B, D]`, numpy in
and out); the batched streaming accumulator keeps only sum / outer-sum so
datasets of any size fit. The Frechet sqrtm uses the eigenvalues of
sigma1 @ sigma2 (numpy on the host: an offline metric, not a hot path).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

Array = np.ndarray


@dataclasses.dataclass
class FIDStats:
    """Streaming mean/covariance accumulator."""

    n: int = 0
    sum: Optional[Array] = None
    outer: Optional[Array] = None

    def update(self, feats: Array) -> "FIDStats":
        f = np.asarray(feats, np.float64)
        if self.sum is None:
            self.sum = f.sum(0)
            self.outer = f.T @ f
        else:
            self.sum += f.sum(0)
            self.outer += f.T @ f
        self.n += f.shape[0]
        return self

    def finalize(self):
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov

    def save(self, path) -> None:
        """Persist the accumulator (the reference caches real-dataset FID
        stats across runs in input/fid.pkl, utils/train.py:125-161)."""
        np.savez(path, n=self.n, sum=self.sum, outer=self.outer)

    @classmethod
    def load(cls, path) -> "FIDStats":
        z = np.load(path)
        return cls(n=int(z["n"]), sum=z["sum"], outer=z["outer"])


def _sqrtm_product_trace(s1: Array, s2: Array) -> float:
    """tr((s1 s2)^{1/2}) via eigenvalues of the (non-symmetric) product."""
    eigvals = np.linalg.eigvals(s1 @ s2)
    eigvals = np.maximum(eigvals.real, 0.0)
    return float(np.sqrt(eigvals).sum())


def frechet_distance(mu1: Array, s1: Array, mu2: Array, s2: Array) -> float:
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * _sqrtm_product_trace(s1, s2))


def fid_from_features(real: Iterable[Array], fake: Iterable[Array]) -> float:
    sr, sf = FIDStats(), FIDStats()
    for f in real:
        sr.update(f)
    for f in fake:
        sf.update(f)
    return frechet_distance(*sr.finalize(), *sf.finalize())


def fid_to(real, images, feature_fn, batch: int = 64) -> float:
    """Frechet distance of `images` (featurized `batch` at a time) to the
    real statistics `real` = (mu, cov): the trainers' per-epoch FID-CLIP."""
    sf = FIDStats()
    for i in range(0, len(images), batch):
        sf.update(feature_fn(images[i:i + batch]))
    return frechet_distance(*real, *sf.finalize())


def inception_feature_fn(inception_params):
    """images01 [B,H,W,3] (numpy, [0,1]) -> pool3 features [B,2048] float32
    (numpy): classic FID, on the device of `inception_params` in f32
    (weights convert from torchvision via models/inception.convert_inception)."""
    from hairfastgan_torch.models.inception import inception_features_nchw

    ref = inception_params["stem"]["c1"]["conv"]["w"]

    @torch.no_grad()
    def fn(images01):
        x = torch.as_tensor(np.asarray(images01, np.float32)).to(ref.device)
        f = inception_features_nchw(inception_params, x.permute(0, 3, 1, 2))
        return f.float().cpu().numpy()

    return fn


def clip_feature_fn(clip_params):
    """images01 [B,H,W,3] (numpy, [0,1]) -> CLIP embeddings [B,512] (numpy):
    the FID-CLIP feature net, on the device and in the dtype of
    `clip_params` (the reference ClipModel normalizes [0,1] directly,
    Encoders.py:153-160)."""
    from hairfastgan_torch.models.clip_vit import clip_encode_image_nchw, clip_preprocess_nchw

    ref = clip_params["proj"]

    @torch.no_grad()
    def fn(images01):
        x = torch.as_tensor(np.asarray(images01, np.float32)).to(ref.device, ref.dtype)
        e = clip_encode_image_nchw(clip_params, clip_preprocess_nchw(x.permute(0, 3, 1, 2)))
        return e.float().cpu().numpy()

    return fn


def compute_fid_datasets(real_images, method_images, feature_fn, batch: int = 128) -> float:
    """Directory-level FID (scripts/fid_metric.py:24-50): one pass of real
    stats, then the method's fake stats."""
    def batches(arr):
        for i in range(0, len(arr), batch):
            yield feature_fn(arr[i:i + batch])

    return fid_from_features(batches(real_images), batches(method_images))
