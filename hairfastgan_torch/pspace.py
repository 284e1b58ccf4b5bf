"""P-space PCA statistics and the p-norm regularizer (counterpart of
hairfastgan_tpu/pspace.py).

Rebuilds reference models/Net.py:48-107 + utils/PCA_utils.py:3-29: PULSE's
"P space" is LeakyReLU(slope 5) of mapping-network outputs; a PCA of 1M
samples gives (X_mean, X_comp, X_stdev) used by the p-norm latent
regularizer `cal_p_norm_loss` and the F-reconstruction loss `cal_l_F`.

The JAX package fits the PCA with sklearn's IncrementalPCA at all 512
components, which is the full eigendecomposition of the samples'
covariance. The port computes that directly (`fit_pca`: float64 covariance
and `numpy.linalg.eigh`, components signed as sklearn signs them), so it
needs no sklearn. The npz keys and layout are the JAX package's: a
`<ckpt>_PCA.npz` built by either package loads in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from hairfastgan_torch.config import StyleGANConfig
from hairfastgan_torch.models import stylegan2

Tensor = torch.Tensor
PCA_KEYS = ("X_mean", "X_comp", "X_stdev")
_CHUNK = 100_000  # rows per float64 covariance update (bounds the float64 copy)


def leaky5(w: Tensor) -> Tensor:
    """W -> P: LeakyReLU with slope 5 on the negative side (PULSE)."""
    return torch.where(w >= 0, w, w * 5.0)


def fit_pca(samples: np.ndarray) -> Dict[str, np.ndarray]:
    """[N, D] P-space samples -> {X_mean, X_comp [D, D] (rows by falling
    variance), X_stdev, X_var_ratio}, float32: the eigendecomposition of the
    samples' covariance (ddof 1), accumulated in float64 a chunk of rows at a
    time. Each component's sign makes its largest-magnitude entry positive
    (sklearn's svd_flip on the components)."""
    x = np.asarray(samples)
    n, dim = x.shape
    mean = x.mean(axis=0, dtype=np.float64)
    cov = np.zeros((dim, dim), np.float64)
    for i in range(0, n, _CHUNK):
        c = x[i:i + _CHUNK].astype(np.float64) - mean
        cov += c.T @ c
    var, vecs = np.linalg.eigh(cov / (n - 1))
    order = np.argsort(var)[::-1]
    var, comp = np.maximum(var[order], 0.0), vecs[:, order].T
    signs = np.sign(comp[np.arange(dim), np.abs(comp).argmax(axis=1)])
    comp = comp * signs[:, None]
    return {
        "X_mean": mean.astype(np.float32),
        "X_comp": comp.astype(np.float32),
        "X_stdev": np.sqrt(var).astype(np.float32),
        "X_var_ratio": (var / var.sum()).astype(np.float32),
    }


@torch.no_grad()
def build_pca_model(generator_params, out_path: Optional[Path], n_samples: int = 1_000_000,
                    batch: int = 100_000, cfg: StyleGANConfig = StyleGANConfig(),
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Sample z on the parameters' device (a torch.Generator seeded with
    `seed`), map and LeakyReLU(5) them in f32 there, then `fit_pca` on the
    host; saved as an npz at `out_path` unless it is None."""
    device = generator_params["style"][0]["w"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    samples = np.empty((n_samples, cfg.style_dim), np.float32)
    for i in range(0, n_samples, batch):
        n = min(batch, n_samples - i)
        z = torch.randn((n, cfg.style_dim), generator=gen, device=device)
        samples[i:i + n] = leaky5(stylegan2.mapping(generator_params, z, cfg)).float().cpu().numpy()
    model = fit_pca(samples)
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **model)
    return model


def load_pca_model(path: Path, device="cpu") -> Dict[str, Tensor]:
    """An npz of build_pca_model (either package's) -> its X_mean, X_comp,
    X_stdev as f32 tensors on `device`."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in PCA_KEYS}


def p_norm_loss(pca: Dict[str, Tensor], latent_in: Tensor, p_norm_lambda: float = 1.0) -> Tensor:
    """cal_p_norm_loss (Net.py:96-103): project the LeakyReLU(5) of the W+
    rows onto the PCA basis, whiten by stdev, mean squared norm; in f32."""
    p = leaky5(latent_in.float()) - pca["X_mean"].float()
    proj = torch.einsum("bls,cs->blc", p, pca["X_comp"].float()) / pca["X_stdev"].float()
    return p_norm_lambda * proj.square().mean()


def l_F_loss(latent_F: Tensor, F_init: Tensor, l_F_lambda: float = 1.0) -> Tensor:
    """cal_l_F (Net.py:105-106): MSE between F tensors."""
    return l_F_lambda * (latent_F - F_init).square().mean()
