"""The module stack (``arch: module``) and the path choice of the configs
the JAX kernels refuse: ``NeRFDINOFusion``, ``DensityMLP``, ``ColorMLP``
and ``NeRFWithDINO`` against the JAX modules on transplanted params, the
trainer's epochs of ``arch: module`` (with the multiscale trainer's
``invalid_fill: mean``) against the JAX trainer, and the
``kernel_path_reason`` of module and skip-layer configs.

Tolerances: the modules rtol 1e-5 / atol 2e-5, as
``test_torch_port_models.py`` (fp32 sums in other orders); the trainer's
epoch losses rtol 1e-4, as ``test_torch_port_train_trainer.py``; the
rendered views of equal weights atol 1e-5 (rgb, acc) and 1e-4 (depth, up to
6): both sides run the plain pipeline with ``cos`` computed directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import fusion as jfusion
from nerf_fewshot_tpu.models import mlp as jmlp
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.fusion import NeRFDINOFusion
from nerf_fewshot_tpu_torch.models.mlp import (
    ColorMLP,
    DensityMLP,
    NeRFWithDINO,
    _linear_from_jax,
    nerf_with_dino_from_jax,
)
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

RNG = np.random.default_rng(41)
N, HIDDEN = 40, 32


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat_state(params):
    """``{name: layer}`` of a JAX module's dense layers -> a state dict."""
    state = {}
    for name, layer in params.items():
        state.update(_linear_from_jax(name, layer))
    return state


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_fusion_matches_jax():
    pos = RNG.standard_normal((N, 39)).astype(np.float32)
    dino = RNG.standard_normal((N, 8)).astype(np.float32)
    jm = jfusion.NeRFDINOFusion(hidden_dim=HIDDEN)
    params = _np(jm.init(jax.random.key(0), jnp.asarray(pos), jnp.asarray(dino))["params"])
    tm = NeRFDINOFusion(39, 8, HIDDEN)
    tm.load_state_dict(_flat_state(params))
    _close(tm(_t(pos), _t(dino)), jm.apply({"params": params}, jnp.asarray(pos),
                                            jnp.asarray(dino)))


def test_density_and_color_mlps_match_jax():
    x = RNG.standard_normal((N, HIDDEN)).astype(np.float32)
    jd = jmlp.DensityMLP(hidden_dim=HIDDEN, num_layers=3)
    pd = _np(jd.init(jax.random.key(1), jnp.asarray(x))["params"])
    td = DensityMLP(HIDDEN, HIDDEN, 3)
    td.load_state_dict({**{k.replace("layer_", "layers."): v for k, v in _flat_state(
        {k: v for k, v in pd.items() if k.startswith("layer_")}).items()},
        **_flat_state({k: pd[k] for k in ("density_head", "feature_head")})})
    w_density, w_feats = jd.apply({"params": pd}, jnp.asarray(x))
    g_density, g_feats = td(_t(x))
    _close(g_density, w_density)
    _close(g_feats, w_feats)
    assert (g_density >= 0).all() and (g_density == 0).any()  # the head is ReLU'd

    dirs = RNG.standard_normal((N, 15)).astype(np.float32)
    jc = jmlp.ColorMLP(hidden_dim=HIDDEN // 2)
    pc = _np(jc.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(dirs))["params"])
    tc = ColorMLP(HIDDEN + 15, HIDDEN // 2)
    tc.load_state_dict(_flat_state(pc))
    _close(tc(_t(x), _t(dirs)), jc.apply({"params": pc}, jnp.asarray(x), jnp.asarray(dirs)))


@pytest.mark.parametrize("num_layers", [2, 4])
def test_nerf_with_dino_matches_jax(num_layers):
    pts = RNG.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    dirs = RNG.standard_normal((N, 3)).astype(np.float32)
    dino = RNG.standard_normal((N, 8)).astype(np.float32)
    jm = jmlp.NeRFWithDINO(pos_freq=6, dir_freq=2, dino_dim=8, hidden_dim=HIDDEN,
                           num_density_layers=num_layers)
    ins = [jnp.asarray(a) for a in (pts, dirs, dino)]
    params = _np(jm.init(jax.random.key(3), *ins)["params"])
    tm = NeRFWithDINO(pos_freq=6, dir_freq=2, dino_dim=8, hidden_dim=HIDDEN,
                      num_density_layers=num_layers)
    state = nerf_with_dino_from_jax(params)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    w_rgb, w_density = jm.apply({"params": params}, *ins)
    g_rgb, g_density = tm(_t(pts), _t(dirs), _t(dino))
    _close(g_rgb, w_rgb)
    _close(g_density, w_density)
    with pytest.raises(ValueError, match="requires dino"):
        tm(_t(pts), _t(dirs))


# ------------------------------------------------------------------ trainer

RES = 16


def _config(mod, **over):
    """The multiscale trainer's surface (``arch: module``, 128-wide
    features, ``invalid_fill`` left to its default, full-resolution focal),
    cut to a 2 x 32 density trunk and 16x16 views."""
    d = {
        "experiment": {"name": "port-module"},
        "data": {"resolution": RES, "num_views": 2},
        "model": {"use_dino": True, "dino_model_type": "multi_scale"},
        "nerf_model": {"pos_freq": 4, "dir_freq": 2, "hidden_dim": HIDDEN, "num_layers": 2,
                       "arch": "module"},
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 1e-3, "weight_decay": 1e-6, "kind": "adamw", "grad_clip": 1.0},
        "rendering": {"chunk_size": 128},
        "output": {"save_dir": "unused", "val_freq": 1, "save_freq": 1},
        "seed": 0,
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 1, img_size=RES, gt_samples=32, split="test")
    feats = np.random.default_rng(4).standard_normal((2, 4, 4, 128)).astype(np.float32)
    return train, test, feats


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


def test_module_arch_train_epoch_matches_the_jax_trainer(scene, monkeypatch):
    """Two epochs (one per phase) from the same transplanted init, the
    features of invalid projections mean-filled on both sides; then the
    views of equal weights."""
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test, feats = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg), train, test, dino_features=feats)
    ptr = Trainer(_config(tcfg), _port_data(train), _port_data(test), device="cpu",
                  dino_features=feats)
    assert ptr.cfg.dino.invalid_fill == jtr.cfg.dino.invalid_fill == "mean"
    assert not ptr.cfg.focal_scaling and isinstance(ptr.model, NeRFWithDINO)
    ptr.load_jax_params(_np(jtr.params))
    for epoch in (0, 1):
        np.testing.assert_allclose(ptr.train_epoch(epoch), jtr.train_epoch(epoch), rtol=1e-4)
    assert ptr.kernel_path == "plain"
    ptr.load_jax_params(_np(jtr.params))
    poses = [np.asarray(test.poses[0])]
    for g, w, name in zip(ptr.render_views(poses), jtr.render_views(poses),
                          ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=1e-4 if name == "depth" else 1e-5, err_msg=name)


@pytest.mark.parametrize("config", ["module", "skip"])
@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_kernel_path_reason_of_module_and_skip_configs(scene, config, backend):
    """The JAX trainer's reason, word for word: under ``auto`` the plain
    path on every device (the trainer's device set to cuda: the choice is
    made before any tensor), under ``fused`` a raise."""
    train, _, feats = scene
    over = ({} if config == "module" else {
        "model": {"use_dino": False}, "nerf_model": {"arch": "functional",
                                                     "hidden_dim": 128, "skip_layers": [1]}})
    jtr = jax_trainer_mod.Trainer(_config(jcfg, **over), train, dino_features=feats)
    want = jtr._kernel_ineligible_reason()
    assert want.startswith("arch=module" if config == "module" else "skip_layers=[1]")
    ptr = Trainer(_config(tcfg, rendering={"backend": backend}, **over), _port_data(train),
                  device="cpu", dino_features=feats)
    for device in ("cpu", "cuda"):
        ptr.device = torch.device(device)
        if backend == "fused":
            with pytest.raises(ValueError, match=f"backend=fused rejected on {device}: "):
                ptr._use_fused()
        else:
            assert ptr._use_fused() is False
            assert (ptr.kernel_path, ptr.kernel_path_reason) == ("plain", want)
    if backend == "auto":
        ptr.device = torch.device("cpu")
        assert np.isfinite(ptr.train_epoch(0))
