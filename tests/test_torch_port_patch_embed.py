"""The standalone scripts' feature path and recipes in the port against the
JAX package, on the same numpy inputs: the PIL-free ``preprocess_vit_b16_input``
(bit for bit against the JAX function, which goes through PIL),
``ViTPatchEmbed`` on transplanted params, the torchvision weight discovery
and load, ``build_feature_extractor('patch_embed')`` end to end, the script
recipes' trainer (768-wide features: D 832 / 864) against the JAX trainer,
and the trainer's kernel-path choice past the old input-width cap.

Sizes are small: the trunks are 3 x 128, the scenes 32x32 with full-image
steps at 16x16 and 8 samples per ray. Tolerances are stated per test; fp32
throughout, the two frameworks summing in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.models import dino as jdino
from nerf_fewshot_tpu.models import vit as jvit
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu.render.train_kernel import fused_train_loss_grad as jax_loss_grad
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models import dino as tdino
from nerf_fewshot_tpu_torch.models import vit as tvit
from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, N_LAYERS = 128, 3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------ preprocessing

@pytest.mark.parametrize("h,w,size", [(128, 128, 224), (16, 16, 224), (64, 64, 224),
                                      (37, 53, 224), (200, 150, 224), (800, 800, 224),
                                      (128, 128, 128)])
def test_preprocessor_is_bit_equal_to_the_jax_pil_one(h, w, size):
    """Up- and downscaling and the identity, values outside [0, 1] clipped:
    the same float32 bits as the JAX function's PIL round trip."""
    x = np.random.default_rng(h * w).uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    want = jvit.preprocess_vit_b16_input(x, size)
    got = tvit.preprocess_vit_b16_input(_t(x), size).numpy()
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------ the conv

def _jax_patch_embed(seed=0):
    model = jvit.ViTPatchEmbed()
    return model, _np_tree(model.init(jax.random.key(seed), jnp.zeros((224, 224, 3)))["params"])


def test_vit_patch_embed_matches_jax():
    """On transplanted params, the (14, 14, 768) grid within 1e-5 of the
    largest value (XLA's conv and the exact fp32 patch product sum the 768
    terms in other orders)."""
    model, params = _jax_patch_embed()
    x = tvit.preprocess_vit_b16_input(_t(np.random.default_rng(1).uniform(0, 1, (128, 128, 3))))
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x.numpy())))
    pe = tvit.ViTPatchEmbed()
    state = tvit.state_dict_from_jax(params)
    assert state["conv_proj.weight"].shape == (768, 3, 16, 16)
    pe.load_state_dict(state)
    got = pe(x).detach().numpy()
    assert got.shape == want.shape == (14, 14, 768)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_vit_patch_embed_init_is_flax_lecun_normal():
    pe = [tvit.ViTPatchEmbed(generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    w = pe[0].conv_proj.weight
    assert torch.equal(w, pe[1].conv_proj.weight) and not torch.equal(w, pe[2].conv_proj.weight)
    std = 1.0 / np.sqrt(3 * 16 * 16)
    assert abs(w.std().item() - std) < 0.03 * std
    assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(pe[0].conv_proj.bias) == 0


def _write_torchvision_state(path, seed=2, **extra):
    """A torchvision-layout ``vit_b_16`` state dict with a random
    ``conv_proj`` and one unrelated key."""
    rng = np.random.default_rng(seed)
    sd = {"conv_proj.weight": torch.tensor(rng.standard_normal((768, 3, 16, 16)) * 0.02,
                                           dtype=torch.float32),
          "conv_proj.bias": torch.tensor(rng.standard_normal(768) * 0.1, dtype=torch.float32),
          "encoder.ln.weight": torch.ones(768), **extra}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd


def test_weight_discovery_and_load_match_jax(tmp_path, monkeypatch):
    """``$NERF_VIT_B16_WEIGHTS`` first, then ``$TORCH_HOME``'s hub cache,
    else None, on both sides; the loaded conv equals the JAX tree's, and a
    missing key or another shape leaves the init."""
    direct = str(tmp_path / "direct.pth")
    cached = str(tmp_path / "th" / "hub" / "checkpoints" / "vit_b_16-c867db91.pth")
    sd = _write_torchvision_state(direct)
    _write_torchvision_state(cached, seed=3)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    monkeypatch.setenv("NERF_VIT_B16_WEIGHTS", direct)
    assert tvit.find_torchvision_vit_b16_weights() == jvit.find_torchvision_vit_b16_weights() \
        == direct
    monkeypatch.setenv("NERF_VIT_B16_WEIGHTS", str(tmp_path / "absent.pth"))
    assert tvit.find_torchvision_vit_b16_weights() == jvit.find_torchvision_vit_b16_weights() \
        == cached
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    assert tvit.find_torchvision_vit_b16_weights() is None
    assert jvit.find_torchvision_vit_b16_weights() is None

    _, params = _jax_patch_embed()
    want = jvit.load_torchvision_patch_embed(params, jvit.load_state_dict_file(direct))
    pe = tvit.ViTPatchEmbed()
    pe.load_state_dict(tvit.state_dict_from_jax(params))
    tvit.load_torchvision_patch_embed(pe, torch.load(direct, weights_only=True))
    for k, v in tvit.state_dict_from_jax(_np_tree(want)).items():
        assert torch.equal(pe.state_dict()[k], v), k
    assert torch.equal(pe.conv_proj.weight, sd["conv_proj.weight"])

    fresh = tvit.ViTPatchEmbed()
    init = {k: v.clone() for k, v in fresh.state_dict().items()}
    tvit.load_torchvision_patch_embed(fresh, {"conv_proj.weight": torch.zeros(768, 3, 14, 14)})
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in init.items())


def test_build_feature_extractor_patch_embed_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``build_feature_extractor('patch_embed')`` load the
    same checkpoint (found through ``$NERF_VIT_B16_WEIGHTS``) and map a
    [0, 1] training view to the same (14, 14, 768) grid, within 1e-5 of its
    largest value (the preprocessed inputs are bit-equal)."""
    path = str(tmp_path / "vit_b_16.pth")
    _write_torchvision_state(path)
    monkeypatch.setenv("NERF_VIT_B16_WEIGHTS", path)
    cfg = jcfg.config_from_dict({"model": {"use_dino": True, "dino_model_type": "patch_embed"}})
    apply, variables = jdino.build_feature_extractor(cfg.dino, 128)
    model = tdino.build_feature_extractor(tcfg.config_from_dict(cfg.raw).dino, 128, device="cpu")
    assert isinstance(model, tdino.PatchEmbedFeatures) and not model.training
    image = np.random.default_rng(5).uniform(0, 1, (128, 128, 3)).astype(np.float32)
    want = np.asarray(apply(variables, image))
    with torch.no_grad():
        got = model(_t(image)).numpy()
    assert got.shape == want.shape == (14, 14, 768)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ the recipes' trainer

RES = 32


def _script_config(mod, name, **over):
    """``experiments/<name>.yaml`` at reduced depth: a 3 x 128 trunk, two
    32x32 views, one full-image phase at 16x16 with 8 samples per ray, two
    epochs; the recipe's feature width, view directions and LoRA as they
    are."""
    with open(os.path.join(ROOT, "experiments", f"{name}.yaml")) as f:
        d = yaml.safe_load(f)
    d["nerf_model"].update(hidden_dim=HIDDEN, num_layers=N_LAYERS)
    d["data"].update(resolution=RES, num_views=2)
    d["training"] = {"epochs": 2, "phases": [
        {"start": 0, "H": 16, "n_samples": 8, "batch_size": "full"}]}
    d["rendering"]["chunk_size"] = 256
    d["output"] = {"save_dir": "unused", "val_freq": 1, "save_freq": 1}
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32, split="test")
    # per-view (14, 14, 768) maps of O(1) values, as the patch embedding gives them
    feats = np.random.default_rng(7).standard_normal((2, 14, 14, 768)).astype(np.float32)
    return train, test, feats


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


@pytest.mark.parametrize("name,d_pad,over", [
    ("script_baseline_live", 832, {}),
    ("script_projection", 864, {}),
    # the two-phase freeze at epoch 1, inside the two epochs
    ("script_lora", 832, {"optimizer": {"lora_only_after_epoch": 1}}),
])
def test_script_trainer_matches_jax_trainer(scene, monkeypatch, name, d_pad, over):
    """A script recipe's trainer on its kernel path (the plain version of
    kernel 1, eval through kernel 2's) from the JAX trainer's transplanted
    init, against the JAX trainer's XLA path on the CPU, with the same
    feature maps: epoch losses within rtol 1e-4, the per-step losses of the
    port's kernel and plain (``backend: xla``) paths within rel 1e-4, the
    views within 1e-4 (depth 1e-3; cos as ``sin(x + pi/2)`` in the kernels'
    plain versions moves a phase at pos_freq 10 by <= 3e-5 rad), eval PSNR
    within 1e-3 dB."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", False)
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test, feats = scene
    jtr = jax_trainer_mod.Trainer(_script_config(jcfg, name, **over), train, test,
                                  dino_features=feats)
    assert jtr.use_dino and not jtr._kernel_eligible()
    trainers = [Trainer(_script_config(tcfg, name, rendering={"backend": b}, **over),
                        _port_data(train), _port_data(test), device="cpu", dino_features=feats)
                for b in ("auto", "xla")]
    ptr, plain = trainers
    assert ptr._use_fused() and not plain._use_fused() and ptr.kernel_path_reason is None
    x_dim = tk.pe_layout(10, 4, ptr.cfg.nerf.use_viewdirs, 768)[3]
    state = ptr.model.state_dict()
    w0 = state.get("trunk.0.weight", state.get("trunk.0.base.weight"))
    assert tk.pe_width(x_dim) == d_pad and w0.shape[1] == x_dim
    for t in trainers:
        t.load_jax_params(_np_tree(jtr.params))
    for epoch in (0, 1):
        want = jtr.train_epoch(epoch)
        got = [t.train_epoch(epoch) for t in trainers]
        np.testing.assert_allclose(got, [want, want], rtol=1e-4)
        assert len(ptr.last_step_losses) == 2  # one full image per view
        np.testing.assert_allclose(ptr.last_step_losses, plain.last_step_losses, rtol=1e-4)
    assert ptr._lora_only_active == ("optimizer" in over) == jtr._lora_only_active
    poses = [np.asarray(test.poses[i]) for i in range(2)]
    got, want = ptr.render_views(poses), jtr.render_views(poses)
    for g, w, out in zip(got, want, ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-3 if out == "depth" else 1e-4,
                                   err_msg=out)
    assert abs(ptr.evaluate()["psnr"] - jtr.evaluate()["psnr"]) < 1e-3


def test_objective_at_d832_matches_the_jax_interpret_kernel():
    """One objective call at the scripts' width (63 PE columns and 768
    features: D 832 in the port, 896 in the JAX kernel; the pad rows add
    exact zeros): the port's plain version of kernel 1 against the JAX
    Pallas kernel in interpret mode, on the same rays, features and
    transplanted weights. Loss within rtol 1e-5; the gradient vector within
    rel 5e-3, as for every feature case: ReLU gates of pre-activations
    within ~1e-6 of zero flip between two fp32 routes."""
    rng = np.random.default_rng(8)
    R, S = 32, 8
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=False, dino_dim=768,
                       hidden_dim=HIDDEN, num_layers=N_LAYERS, sigma_bias_init=0.1)
    params = _np_tree(model.init(jax.random.key(0), jnp.zeros((1, 3)), jnp.zeros((1, 3)),
                                 jnp.zeros((1, 768)))["params"])
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = np.ones(R, np.float32)
    feats = rng.standard_normal((R * S, 768)).astype(np.float32)
    want_loss, want_grads = jax_loss_grad(
        params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), jnp.asarray(mask),
        JaxRenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False), 10, 4, N_LAYERS,
        HIDDEN, use_viewdirs=False, interpret=True, point_features_fn=lambda p: jnp.asarray(feats))
    args, opts = tt.train_objective_inputs(
        {k: v.requires_grad_(True) for k, v in nerf_mlp_from_jax(params).items()}, _t(ro),
        _t(rd), _t(tgt), _t(mask), RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False),
        10, 4, N_LAYERS, HIDDEN, use_viewdirs=False, point_features_fn=lambda p: _t(feats))
    assert args[-1][0].shape == (832, HIDDEN)
    got_loss, got_grads = tt.fused_train_loss_grad(
        nerf_mlp_from_jax(params), _t(ro), _t(rd), _t(tgt), _t(mask),
        RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False), 10, 4, N_LAYERS, HIDDEN,
        use_viewdirs=False, point_features_fn=lambda p: _t(feats))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    want = nerf_mlp_from_jax(_np_tree(want_grads))
    g = torch.cat([got_grads[k].reshape(-1).double() for k in want])
    w = torch.cat([want[k].reshape(-1).double() for k in want])
    assert w.norm() > 1e-6 and ((g - w).norm() / w.norm()).item() < 5e-3


# ------------------------------------------------------------ the width cap

def test_port_gap_reason_takes_the_script_widths_and_refuses_past_the_cap(scene):
    """D 832 (63 + 768) and D 864 (90 + 768) take the kernels, on the CPU and
    as the choice a card makes; so, past the port's former 896-column cap,
    does a wider input (963 live columns, D 976), under ``auto`` and
    ``backend: fused``: the kernel path on the CPU (the kernels' plain
    versions, one step of it here) and as the choice a card makes. (The
    trainer's ``_port_gap_reason`` that this test once read is gone: every
    config the JAX kernels take, the port's kernels take too.)"""
    train, test, feats = scene
    assert not hasattr(tk, "MAX_INPUT_WIDTH")
    for name in ("script_baseline_live", "script_projection"):
        tr = Trainer(_script_config(tcfg, name), _port_data(train), device="cpu",
                     dino_features=feats)
        assert not hasattr(tr, "_port_gap_reason") and tr._jax_ineligible_reason() is None
        tr.device = torch.device("cuda", 0)
        assert tr._use_fused() and tr.kernel_path == "kernel"
    wide = np.zeros((2, 2, 2, 900), np.float32)
    for backend in ("auto", "fused"):
        tr = Trainer(_script_config(tcfg, "script_baseline_live", model={"dino_dim": 900},
                                    rendering={"backend": backend}),
                     _port_data(train), device="cpu", dino_features=wide)
        assert tk.pe_width(tk.pe_layout(10, 4, tr.cfg.nerf.use_viewdirs, 900)[3]) == 976
        assert tr._jax_ineligible_reason() is None
        assert tr._use_fused() and (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)
        tr.device = torch.device("cuda", 0)
        assert tr._use_fused() and tr.kernel_path == "kernel"
    tr.device = torch.device("cpu")
    args, opts = tt.train_objective_inputs(
        {k: v.detach() for k, v in tr.model.named_parameters()},
        torch.zeros((4, 3)) + torch.tensor([0.0, 0.0, 4.0]),
        torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1), torch.rand(4, 3), torch.ones(4),
        RenderSettings(near=2.0, far=6.0, n_samples=8), 10, 4, tr.cfg.nerf.num_layers,
        tr.cfg.nerf.hidden_dim, use_viewdirs=tr.cfg.nerf.use_viewdirs,
        point_features_fn=lambda p: torch.zeros((p.shape[0], 900)))
    assert args[-1][0].shape[0] == 976
    loss, grads = tt.fused_train_objective(*args, **opts)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
