"""Sigma noise outside the strict reference behavior, against the JAX
package: the plain ``render_rays`` with ``noise_std`` (coarse pass, and the
fine pass with ``n_importance``), and a non-strict noisy ``Trainer`` epoch.

The JAX ``render_rays`` splits one key four ways (strata, noise, importance,
fine noise); the test draws the uniforms and normals with ``jax.random``
from the same split keys and injects them into the port, so both sides
render the same noised densities. Tolerance 1e-5 abs on rgb, depth and acc
(fp32 sums in another order). The kernels refuse noise, as the JAX kernels
do; those refusals are pinned in the kernel and trainer tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu.render.pipeline import render_rays as jax_render_rays
from nerf_fewshot_tpu_torch.data import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

R, S, NI, NOISE = 24, 16, 16, 1.0


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _setup():
    jmodel = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=128,
                        num_layers=3, sigma_bias_init=0.1)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"])
    rng = np.random.default_rng(3)
    ro = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (R, 3)).copy()
    rd = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    model = NeRFMLP(10, 4, True, hidden_dim=128, num_layers=3)
    model.load_state_dict(nerf_mlp_from_jax(params))
    return jmodel, params, model, ro, rd


@pytest.mark.parametrize("n_importance", [0, NI])
def test_noisy_render_rays_matches_jax(n_importance):
    """``noise_std`` 1.0 with perturbed samples: the port with JAX's four
    draws injected equals ``render_rays(..., key)`` within 1e-5; the noise
    moves the render; drawn from a generator, the normals are those the
    same generator would give in the order coarse, fine."""
    jmodel, params, model, ro, rd = _setup()
    key = jax.random.key(9)
    want = jax.jit(lambda o, d, k: jax_render_rays(
        lambda p, dirs, f: jmodel.apply({"params": params}, p, dirs), o, d,
        JaxRenderSettings(n_samples=S, n_importance=n_importance, perturb=True,
                          noise_std=NOISE), key=k))(jnp.asarray(ro), jnp.asarray(rd), key)
    k_strat, k_noise, k_imp, k_noise2 = jax.random.split(key, 4)
    u = np.asarray(jax.random.uniform(k_strat, (R, S)))
    n1 = np.asarray(jax.random.normal(k_noise, (R, S)))
    ui = np.asarray(jax.random.uniform(k_imp, (R, NI)))
    n2 = np.asarray(jax.random.normal(k_noise2, (R, S + NI)))
    settings = RenderSettings(n_samples=S, n_importance=n_importance, perturb=True,
                              noise_std=NOISE)
    with torch.no_grad():
        got = render_rays(model, _t(ro), _t(rd), settings, _t(u), _t(ui),
                          normals=_t(n1), fine_normals=_t(n2))
        quiet = render_rays(model, _t(ro), _t(rd),
                            RenderSettings(n_samples=S, n_importance=n_importance, perturb=True),
                            _t(u), _t(ui))
    assert got.weights.shape == (R, S + n_importance)
    for name in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert np.abs(got.rgb.numpy() - quiet.rgb.numpy()).max() > 1e-3

    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        drawn = render_rays(model, _t(ro), _t(rd), settings, _t(u), _t(ui), generator=g)
    g = torch.Generator().manual_seed(4)
    normals = torch.randn((R, S), generator=g)
    fine = torch.randn((R, S + n_importance), generator=g) if n_importance else None
    with torch.no_grad():
        injected = render_rays(model, _t(ro), _t(rd), settings, _t(u), _t(ui),
                               normals=normals, fine_normals=fine)
    torch.testing.assert_close(drawn.rgb, injected.rgb, rtol=0, atol=0)


def test_non_strict_noisy_trainer_epoch_trains_on_the_plain_path():
    """``strict_reference_behavior: false`` with ``rendering.noise_std``: the
    plain path with the JAX trainer's reason, a finite epoch loss, and the
    noise in it (the first step's loss differs from the same trainer's
    without noise, both on ``backend: xla``)."""
    data = make_scene_dataset(lego_like_scene(), 2, img_size=16, gt_samples=32, device="cpu")

    def trainer(noise, backend="auto"):
        cfg = tcfg.config_from_dict({
            "data": {"resolution": 16, "num_views": 2},
            "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128, "num_layers": 2,
                           "sigma_bias": 0.1},
            "training": {"epochs": 1, "phases": [{"start": 0, "H": 16, "n_samples": 8,
                                                  "batch_size": 128}]},
            "rendering": {"noise_std": noise, "backend": backend},
            "strict_reference_behavior": False, "seed": 0})
        return Trainer(cfg, data, device="cpu")

    noisy = trainer(1.0)
    loss = noisy.train_epoch(0)
    assert noisy.kernel_path == "plain"
    assert noisy.kernel_path_reason == "sigma noise_std != 0 is not implemented in the kernels"
    assert np.isfinite(loss) and np.isfinite(noisy.last_step_losses).all()
    quiet = trainer(0.0, backend="xla")
    quiet.train_epoch(0)
    assert quiet.kernel_path == "plain"
    assert abs(noisy.last_step_losses[0] - quiet.last_step_losses[0]) > 1e-6
