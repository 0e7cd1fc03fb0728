"""Both trainers through a phase switch on ``multi_scale`` maps: the
``multiscale.yaml`` recipe (pos_freq 12, dir_freq 4, 128 fused features, no
white background, strict reference behavior, an LR milestone inside each
phase) cut to 2 views at 32x32, a 16x16 -> 32x32 switch at epoch 2 and a
3x128 trunk.

One JAX ``MultiScaleDINOFeatures`` (a 2-layer ViT of hidden 64, patch 8:
4x4, 2x2 and 1x1 grids fused to (4, 4, 128)) gives the JAX maps; the port's
extractor on its transplanted params (``dino_extractor_from_jax``) gives
the port's. The JAX trainer's init is transplanted into the port
(``load_jax_params``) and the stratified jitter is off on both sides. Epoch
by epoch, across the switch, the per-step losses agree within rel 1e-4
(two fp32 Adam trajectories; printed under ``-s``), and so do the phase
data, the learning rate and the feature sampler at the new resolution. The
JAX side trains through its Pallas train kernel in interpret mode
(``FORCE_INTERPRET_KERNELS``) against the port's kernel path, and on its XLA
path against the port's plain path (``backend: xla``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import dino as jdino
from nerf_fewshot_tpu.models import vit as jvit
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models import dino as tdino
from nerf_fewshot_tpu_torch.models import vit as tvit
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

RES = 32
EPOCHS = 4
SWITCH = 2
VIT = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=8)


def _config(mod, backend):
    return mod.config_from_dict({
        "experiment": {"name": "port-switch"},
        "data": {"resolution": RES, "num_views": 2},
        "model": {"use_dino": True, "dino_model_type": "multi_scale"},
        "nerf_model": {"pos_freq": 12, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        # 256 rays per view in batches of 160 (ragged tail of 96), then 1024
        # in batches of 640 (ragged tail of 384)
        "training": {"epochs": EPOCHS, "phases": [
            {"start": 0, "end": SWITCH, "H": 16, "n_samples": 8, "batch_size": 160},
            {"start": SWITCH, "H": RES, "n_samples": 12, "batch_size": 640}]},
        "optimizer": {"lr": 2e-4, "weight_decay": 1e-6, "lr_milestones": [1, 3],
                      "lr_gamma": 0.5},
        "loss": {"rgb_weight": 1.0, "depth_weight": 0.1, "reg_weight": 1e-4},
        "rendering": {"chunk_size": 256, "noise_std": 0.1, "white_bkgd": False,
                      "backend": backend},
        "output": {"save_dir": "unused", "val_freq": 1000, "save_freq": 1000},
        "seed": 0,
    })


@pytest.fixture(scope="module")
def setup():
    """The scene, and the maps of one JAX extractor on each side."""
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    jm = jdino.MultiScaleDINOFeatures(vit=jvit.ViTConfig(**VIT))
    images = np.asarray(train.white_composited(), np.float32)
    params = jax.jit(jm.init)(jax.random.key(3), jnp.asarray(images[0]))["params"]
    apply = jax.jit(jm.apply)
    jmaps = np.stack([np.asarray(apply({"params": params}, jnp.asarray(im))) for im in images])
    tm = tdino.MultiScaleDINOFeatures(vit=tvit.ViTConfig(**VIT))
    tm.load_state_dict(tdino.dino_extractor_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        tmaps = np.stack([tm.eval()(torch.from_numpy(im)).numpy() for im in images])
    assert jmaps.shape == (2, 4, 4, 128)
    np.testing.assert_allclose(tmaps, jmaps, rtol=0, atol=1e-5)
    return train, jmaps, tmaps


def _step_losses(monkeypatch, jtr):
    """Record the JAX trainer's per-step losses: its epoch function returns
    them as its third output, (V, n_batches)."""
    seen = []
    orig = jtr._make_step_fn

    def make(phase_idx):
        fn = orig(phase_idx)

        def wrapped(*a):
            out = fn(*a)
            seen.append(np.asarray(out[2]).reshape(-1))
            return out

        return wrapped

    monkeypatch.setattr(jtr, "_make_step_fn", make)
    return seen


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_switch_matches_jax_trainer(setup, monkeypatch, backend):
    train, jmaps, tmaps = setup
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", backend == "auto")
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    jtr = jax_trainer_mod.Trainer(_config(jcfg, backend), train, dino_features=jmaps)
    assert jtr._kernel_eligible() == (backend == "auto")
    ptr = Trainer(_config(tcfg, backend), BlenderDataset(
        np.asarray(train.images), np.asarray(train.poses), train.H, train.W, train.focal),
        device="cpu", dino_features=tmaps)
    assert ptr._use_fused() == (backend == "auto")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    jax_losses = _step_losses(monkeypatch, jtr)
    for epoch in range(EPOCHS):
        phase = ptr._phase_index(epoch)
        assert phase == jtr._phase_index(epoch) == int(epoch >= SWITCH)
        jtr.train_epoch(epoch)
        ptr.train_epoch(epoch)
        want = jax_losses[-1]
        assert len(want) == len(ptr.last_step_losses) == 2 * 2, epoch
        print(f"{backend} epoch {epoch}: per-step max rel "
              f"{np.abs(ptr.last_step_losses / want - 1).max():.2e}")
        np.testing.assert_allclose(ptr.last_step_losses, want, rtol=1e-4,
                                   err_msg=f"epoch {epoch}")
        # the rate each side set for this epoch
        jlr = float(np.asarray(jtr.opt_state.hyperparams["learning_rate"]))
        assert ptr.optimizer.param_groups[0]["lr"] == pytest.approx(jlr, rel=1e-7)
        assert jlr == pytest.approx(2e-4 * 0.5 ** sum(epoch >= m for m in (1, 3)), rel=1e-7)
    # the phase data and the feature sampler at the new resolution
    jpd, ppd = jtr.phase_data(1), ptr.phase_data(1)
    assert (ppd.H, ppd.W) == (jpd.H, jpd.W) == (RES, RES)
    for name in ("rays_o", "rays_d", "targets"):
        np.testing.assert_allclose(getattr(ppd, name).numpy(), np.asarray(getattr(jpd, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    pts = (ppd.rays_o[1][::7, None] + ppd.rays_d[1][::7, None]
           * torch.linspace(2.0, 6.0, 5)[None, :, None]).reshape(-1, 3)
    want = np.asarray(jtr.feature_sampler(jnp.asarray(jmaps[1]), jtr.poses[1])(
        jnp.asarray(pts.numpy())))
    got = ptr.feature_sampler(1)(pts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1
