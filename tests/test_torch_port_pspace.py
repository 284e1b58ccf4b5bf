"""The port's mapping network (models/stylegan2.mapping, generate,
mean_latent, latent_to_wplus) and P-space PCA (hairfastgan_torch/pspace.py)
against the JAX package's, f32, CPU.

The generator is the JAX init_generator_params at StyleGANConfig(size=32,
max_channels=32), bridged: its own init law (EqualLinear weights
N(0,1) / lr_mul) gives a mapping network whose P space spreads, where the
flat 0.05 fill collapses it onto the biases. The PCA is held against sklearn's
IncrementalPCA, fitted as the JAX build_pca_model fits it, on the same
P-space samples. Tolerances: models 2e-4 of the reference's scale, losses
1e-5 relative, the PCA's mean 1e-6 of its scale, its stdev 1e-3 relative, its leading
well-separated components 1e-3, sign included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu import pspace as jps
from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_torch import pspace as tps
from hairfastgan_torch.config import StyleGANConfig
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.params.bridge import bridge_zoo
from tests.torch_port_util import close

torch.set_num_threads(2)
JCFG = JSG(size=32, max_channels=32)
TCFG = StyleGANConfig(size=32, max_channels=32)
LOSS_REL = 1e-5


@pytest.fixture(scope="module")
def gen():
    jp = jax.tree.map(np.asarray, jsg.init_generator_params(jax.random.PRNGKey(21), JCFG))
    return jax.tree.map(jnp.asarray, jp), bridge_zoo(jp)


@pytest.fixture(scope="module")
def samples(gen):
    """4096 P-space samples: the JAX mapping of seeded z, LeakyReLU(5)."""
    jp, _ = gen
    z = np.random.default_rng(3).standard_normal((4096, 512)).astype(np.float32)
    w = np.asarray(jax.jit(lambda p, z: jsg.mapping(p, z, JCFG))(jp, jnp.asarray(z)))
    return np.where(w >= 0, w, w * 5.0).astype(np.float32)


def test_mapping_and_wplus_match_jax(gen):
    jp, tp = gen
    z = np.random.default_rng(1).standard_normal((4, 512)).astype(np.float32)
    ref = np.asarray(jsg.mapping(jp, jnp.asarray(z), JCFG))
    got = tsg.mapping(tp, torch.from_numpy(z), TCFG).numpy()
    close(got, ref)
    wp = tsg.latent_to_wplus(torch.from_numpy(got), TCFG.n_latent)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jsg.latent_to_wplus(
        jnp.asarray(got), JCFG.n_latent)))
    assert tsg.latent_to_wplus(wp, TCFG.n_latent) is wp


def test_generate_matches_jax(gen):
    jp, tp = gen
    lat = np.random.default_rng(2).standard_normal((2, JCFG.n_latent, 512)).astype(np.float32)
    ref = np.asarray(jsg.generate(jp, jnp.asarray(lat), cfg=JCFG))
    got = tsg.generate(tp, torch.from_numpy(lat), cfg=TCFG).numpy()
    assert got.shape == (2, 32, 32, 3)
    close(got, ref)


def test_mean_latent_matches_jax_mapping(gen):
    """mean_latent draws z from the torch generator; the JAX mapping of the
    same z, averaged, is the reference."""
    jp, tp = gen
    got = tsg.mean_latent(tp, torch.Generator().manual_seed(5), 256, TCFG).numpy()
    z = torch.randn((256, 512), generator=torch.Generator().manual_seed(5)).numpy()
    ref = np.asarray(jsg.mapping(jp, jnp.asarray(z), JCFG)).mean(0, keepdims=True)
    assert got.shape == (1, 512)
    close(got, ref)


def _ipca(samples, chunk=1024):
    """The JAX build_pca_model's fit on given samples."""
    from sklearn.decomposition import IncrementalPCA

    total = np.zeros((512,), np.float64)
    for i in range(0, len(samples), chunk):
        total += samples[i:i + chunk].sum(0)
    mean = (total / len(samples)).astype(np.float32)
    ipca = IncrementalPCA(512, batch_size=max(100, 5 * 512))
    for i in range(0, len(samples), chunk):
        ipca.partial_fit(samples[i:i + chunk] - mean)
    return mean, ipca


def test_fit_pca_matches_incremental_pca(samples):
    mean, ipca = _ipca(samples)
    got = tps.fit_pca(samples)
    # the JAX fit sums float32 chunks: 1e-6 of the mean's scale
    np.testing.assert_allclose(got["X_mean"], mean, rtol=0, atol=1e-6 * np.abs(mean).max())
    stdev = np.sqrt(ipca.explained_variance_)
    np.testing.assert_allclose(got["X_stdev"], stdev, rtol=1e-3)
    np.testing.assert_allclose(got["X_var_ratio"], ipca.explained_variance_ratio_, rtol=1e-3,
                               atol=1e-7)
    comp = got["X_comp"]
    np.testing.assert_allclose(comp @ comp.T, np.eye(512), atol=1e-4)
    # a component is defined only where its variance stands clear of its
    # neighbours' (here gaps of 0.6-20%), and only up to sign; fit_pca signs
    # it as sklearn does, so the signs agree too
    var = ipca.explained_variance_
    gap = np.minimum(np.abs(np.diff(var, prepend=np.inf)), np.abs(np.diff(var, append=0))) / var
    lead = [i for i in range(32) if gap[i] > 0.005]
    assert len(lead) >= 16, gap[:32]
    for i in lead:
        np.testing.assert_allclose(comp[i], ipca.components_[i], atol=1e-3)
    # the leading variances agree to 2.8e-7 relative; 1e-5 pins fit_pca's
    # n-1 (IncrementalPCA's explained_variance_), whose stdev differs from
    # an n-normalised one by 1.2e-4 at these 4,096 samples
    np.testing.assert_allclose(got["X_stdev"][lead], stdev[lead], rtol=1e-5)


def test_build_pca_model_is_fit_of_its_samples(gen, tmp_path):
    """build_pca_model = fit_pca over the mapped z that a torch generator
    seeded with `seed` draws, batch by batch; saved in the JAX npz layout."""
    _, tp = gen
    out = tmp_path / "g_PCA.npz"
    model = tps.build_pca_model(tp, out, n_samples=3000, batch=1024, cfg=TCFG, seed=7)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        s = torch.cat([tps.leaky5(tsg.mapping(tp, torch.randn((n, 512), generator=g), TCFG))
                       for n in (1024, 1024, 952)]).numpy()
    ref = tps.fit_pca(s)
    for k in ("X_mean", "X_comp", "X_stdev", "X_var_ratio"):
        np.testing.assert_array_equal(model[k], ref[k])
    with np.load(out) as z:
        assert sorted(z.files) == ["X_comp", "X_mean", "X_stdev", "X_var_ratio"]
    # the JAX package reads the port's file
    jpca = jps.load_pca_model(out)
    np.testing.assert_array_equal(np.asarray(jpca["X_comp"]), model["X_comp"])


def test_losses_match_jax(gen, samples):
    jp, _ = gen
    pca = tps.fit_pca(samples)
    lat = np.random.default_rng(8).standard_normal((2, JCFG.n_latent, 512)).astype(np.float32)
    ref = float(jps.p_norm_loss({k: jnp.asarray(pca[k]) for k in tps.PCA_KEYS},
                                jnp.asarray(lat), 0.7))
    got = float(tps.p_norm_loss({k: torch.from_numpy(pca[k]) for k in tps.PCA_KEYS},
                                torch.from_numpy(lat), 0.7))
    assert abs(got - ref) <= LOSS_REL * abs(ref)
    a, b = (np.random.default_rng(s).standard_normal((1, 32, 32, 512)).astype(np.float32)
            for s in (9, 10))
    ref = float(jps.l_F_loss(jnp.asarray(a), jnp.asarray(b), 0.3))
    got = float(tps.l_F_loss(torch.from_numpy(a), torch.from_numpy(b), 0.3))
    assert abs(got - ref) <= LOSS_REL * abs(ref)


def test_jax_built_pca_loads_in_port(gen, tmp_path):
    """A <ckpt>_PCA.npz that the JAX build_pca_model wrote loads through the
    port's load_pca_model, and both p_norm_losses agree on it."""
    jp, _ = gen
    out = tmp_path / "jax_PCA.npz"
    jps.build_pca_model(jp, out, n_samples=2048, batch=1024, cfg=JCFG)
    tpca = tps.load_pca_model(out)
    with np.load(out) as z:
        for k in tps.PCA_KEYS:
            assert tpca[k].dtype == torch.float32
            np.testing.assert_array_equal(tpca[k].numpy(), z[k])
    lat = np.asarray(jsg.latent_to_wplus(jsg.mapping(
        jp, jax.random.normal(jax.random.PRNGKey(4), (4, 512)), JCFG), JCFG.n_latent))
    ref = float(jps.p_norm_loss(jps.load_pca_model(out), jnp.asarray(lat)))
    got = float(tps.p_norm_loss(tpca, torch.from_numpy(lat)))
    assert abs(got - ref) <= LOSS_REL * abs(ref)
