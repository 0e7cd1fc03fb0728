"""The port's feature-conditioning slice against the JAX package on the
same numpy inputs: the YAML reader, ``grid_sample`` / ``resize_bilinear``,
the two projections, ``LoRADense``, the ViT and both DINO extractors (on
transplanted params, LoRA on and off), the trainer's feature sampler,
``NeRFMLP(dino_dim)``, and the DINO trainer's epochs and eval.

Widths are small: a ViT of hidden 64, 2 layers, 4 heads, MLP 128, patch 14
on a 128x128 image (9x9 patches); NeRF trunks of 2-3 x 128. Tolerances are
stated per test; fp32 throughout, the two frameworks summing in other
orders.
"""

import glob
import math
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
from nerf_fewshot_tpu.models import dino as jdino
from nerf_fewshot_tpu.models import lora as jlora
from nerf_fewshot_tpu.models import mlp as jmlp
from nerf_fewshot_tpu.models import vit as jvit
from nerf_fewshot_tpu.ops import interp as jinterp
from nerf_fewshot_tpu.ops import rays as jrays
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models import dino as tdino
from nerf_fewshot_tpu_torch.models import lora as tlora
from nerf_fewshot_tpu_torch.models import vit as tvit
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.ops import interp as tinterp
from nerf_fewshot_tpu_torch.ops import rays as trays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer, _feature_sampler
from nerf_fewshot_tpu_torch.utils import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=14)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _with_live_lora_b(params, seed=5):
    """LoRA's B starts at zero; give it values so the update is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        if "lora_b" in jax.tree_util.keystr(p) else x, params)


# --------------------------------------------------------------------- yaml


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "experiments", "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    """Every experiment file parses to exactly ``yaml.safe_load``'s value,
    types included (projection.yaml's ``2e-4`` is a string there)."""
    with open(path) as f:
        text = f.read()
    want, got = yaml.safe_load(text), yaml_subset.safe_load(text)
    assert repr(got) == repr(want)


def test_yaml_reader_keeps_the_yaml11_string_trap():
    with open(os.path.join(ROOT, "experiments", "projection.yaml")) as f:
        got = yaml_subset.safe_load(f.read())
    assert got["training"]["learning_rate"] == "2e-4"
    assert got["training"]["weight_decay"] == "1e-6"


@pytest.mark.parametrize("text", [
    "a: 2e-4\nb: 1.0e-6\nc: 1e6\nd: .5\ne: -1_000\nf: 010\ng: 0x1F\nh: 0b101\ni: 1:30\n",
    "a: yes\nb: Off\nc: ~\nd:\ne: NULL\nf: -.inf\ng: True\nh: n\n",
    "a: 'it''s # not'\nb: \"tab\\there\"\nc: x#y  # comment\nd: \"#\"\ne: '1.0'\n",
    "a: [1, [2, 3], {x: 1, y: [a, b]}, 'q', 2.5]\nb: {}\nc: []\n",
    "x:\n  - 1\n  - two\n  -\n    k: v\n  - k: 1\n    j: [2]\ny:\n- a\n- b\n",
    "top:\n  nested:\n    deep: 3.\n  other: +5\nlast: 7\n",
], ids=["numbers", "bools-nulls", "quotes-comments", "flow", "sequences", "nesting"])
def test_yaml_reader_types_scalars_as_safe_load(text):
    assert repr(yaml_subset.safe_load(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a: |\n  x\n", "a: &x 1\n", "a: 1\n---\nb: 2\n", "a: 2001-12-14\n"])
def test_yaml_reader_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        yaml_subset.safe_load(text)


# ------------------------------------------------------------------ interp


@pytest.mark.parametrize("shape", [(9, 9, 64), (20, 17, 5)], ids=["9x9-matmul", "20x17-gather"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(shape, align_corners):
    """Points inside, on the border and outside the map (zero padding). JAX
    samples maps of <= 256 cells by a weight-matrix product, larger ones by
    gathers; the port always gathers. atol 1e-6 on O(1) features."""
    f = RNG.standard_normal(shape).astype(np.float32)
    p = RNG.uniform(-1.5, 1.5, (400, 2)).astype(np.float32)
    p[:6] = [[-1, -1], [1, 1], [0, 0], [-1, 1], [1, -1], [1.2, -1.3]]
    want = np.asarray(jinterp.grid_sample(jnp.asarray(f), jnp.asarray(p), align_corners))
    got = tinterp.grid_sample(_t(f), _t(p), align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[np.abs(p).max(axis=1) > 1.3]).max() < np.abs(f).max()


@pytest.mark.parametrize("out_hw", [(4, 5), (37, 30), (1, 1), (9, 9)],
                         ids=["down", "up", "one", "same"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align_corners):
    """The same source coordinates and tap weights: equal to 1e-6."""
    img = RNG.standard_normal((9, 11, 6)).astype(np.float32)
    want = np.asarray(jinterp.resize_bilinear(jnp.asarray(img), *out_hw, align_corners))
    got = tinterp.resize_bilinear(_t(img), *out_hw, align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- projections


def _pose():
    """A random rotation, the camera inside the points' box: points on both
    sides of it."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(RNG.standard_normal((3, 3)))[0]
    c2w[:3, 3] = RNG.uniform(-0.5, 0.5, 3)
    return c2w


def test_project_points_to_image_matches_jax():
    """The inverse pose differs by ulps (LU in each framework): points to
    rel 1e-4 of their scale, depths to 1e-5; the validity mask equal
    wherever |z| > 1e-4."""
    c2w, pts = _pose(), RNG.uniform(-2, 2, (300, 3)).astype(np.float32)
    p2, z, valid = jrays.project_points_to_image(jnp.asarray(pts), jnp.asarray(c2w), 111.0, 128, 96)
    q2, zt, vt = trays.project_points_to_image(_t(pts), _t(c2w), 111.0, 128, 96)
    np.testing.assert_allclose(zt.numpy(), np.asarray(z), rtol=0, atol=1e-5)
    keep = np.abs(np.asarray(z)) > 1e-2
    np.testing.assert_allclose(q2.numpy()[keep], np.asarray(p2)[keep], rtol=1e-4, atol=1e-4)
    sure = np.abs(np.asarray(z)) > 1e-4
    np.testing.assert_array_equal(vt.numpy()[sure], np.asarray(valid)[sure])
    assert vt.dtype == torch.bool and 0 < vt.sum() < len(vt)


def test_project_points_script_matches_jax():
    """No inverse: the same products, equal to rel 1e-5."""
    c2w, pts = _pose(), RNG.uniform(-2, 2, (300, 3)).astype(np.float32)
    p2, z = jrays.project_points_script(jnp.asarray(pts), jnp.asarray(c2w), 111.0, 128, 96)
    q2, zt = trays.project_points_script(_t(pts), _t(c2w), 111.0, 128, 96)
    np.testing.assert_allclose(zt.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    keep = np.abs(np.asarray(z)) > 1e-2
    np.testing.assert_allclose(q2.numpy()[keep], np.asarray(p2)[keep], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------- models


def test_lora_dense_matches_jax():
    """A non-zero B (the update exercised), deterministic: rel 1e-6."""
    x = RNG.standard_normal((10, 24)).astype(np.float32)
    mod = jlora.LoRADense(16, rank=4, alpha=8.0)
    params = _with_live_lora_b(_np_tree(mod.init(jax.random.key(0), jnp.asarray(x))["params"]))
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    got_mod = tlora.LoRADense(24, 16, rank=4, alpha=8.0)
    got_mod.load_state_dict(tvit.state_dict_from_jax(params))
    got = got_mod.eval()(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(want - x @ params["base"]["kernel"] - params["base"]["bias"]).max() > 1e-3


def test_lora_dense_init_distributions():
    """A ~ U(+-1/sqrt(in)) (kaiming_uniform a=sqrt(5)), B = 0, base = torch
    Linear's default; dropout only in training mode."""
    g = torch.Generator().manual_seed(0)
    mod = tlora.LoRADense(256, 64, rank=8, generator=g)
    bound = 1.0 / math.sqrt(256)
    assert mod.lora_a.shape == (256, 8) and mod.lora_b.shape == (8, 64)
    assert mod.lora_a.abs().max() <= bound and mod.lora_a.abs().max() > 0.9 * bound
    assert torch.count_nonzero(mod.lora_b) == 0
    with torch.no_grad():
        mod.lora_b.normal_()
    x = torch.randn(4, 256)
    assert torch.equal(mod.eval()(x), mod.eval()(x))
    assert not torch.equal(mod.train()(x), mod.eval()(x))


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_vit_matches_jax(lora_rank):
    """Tokens of a 128x128 image (9x9 patches + CLS; the last 2 pixel rows
    and columns dropped by the VALID stride-14 conv, the 37x37 table resized
    to 9x9) on transplanted params: atol 1e-5 on O(1) LayerNorm outputs."""
    img = RNG.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    jm = jvit.DINOv2ViT(jvit.ViTConfig(**TINY, lora_rank=lora_rank))
    params = _with_live_lora_b(_np_tree(jm.init(jax.random.key(1), jnp.asarray(img))["params"]))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img)))
    tm = tvit.DINOv2ViT(tvit.ViTConfig(**TINY, lora_rank=lora_rank))
    tm.load_state_dict(tvit.vit_from_jax(params))
    with torch.no_grad():
        got = tm.eval()(_t(img)).numpy()
    assert got.shape == want.shape == (82, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["single_scale", "multi_scale"])
@pytest.mark.parametrize("lora_rank", [0, 4])
def test_extractor_matches_jax(kind, lora_rank):
    """``SpatialDINOFeatures`` -> (9, 9, 64) and ``MultiScaleDINOFeatures``
    (scales 1/2/4 -> 9x9, 4x4, 2x2 grids, resized to 9x9) -> (9, 9, 128) on
    transplanted params: atol 1e-5."""
    img = RNG.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    jcls, tcls = {"single_scale": (jdino.SpatialDINOFeatures, tdino.SpatialDINOFeatures),
                  "multi_scale": (jdino.MultiScaleDINOFeatures, tdino.MultiScaleDINOFeatures)}[kind]
    jm = jcls(vit=jvit.ViTConfig(**TINY, lora_rank=lora_rank))
    params = _with_live_lora_b(_np_tree(jm.init(jax.random.key(2), jnp.asarray(img))["params"]))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img)))
    tm = tcls(vit=tvit.ViTConfig(**TINY, lora_rank=lora_rank))
    tm.load_state_dict(tdino.dino_extractor_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(img)).numpy()
    assert got.shape == want.shape == (9, 9, 64 if kind == "single_scale" else 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_multiscale_backbone_gets_no_gradient():
    """The backbone (and its LoRA) runs under no_grad: only the fusion
    stack trains, as with JAX's stop_gradient."""
    tm = tdino.MultiScaleDINOFeatures(vit=tvit.ViTConfig(**TINY, lora_rank=4),
                                      generator=torch.Generator().manual_seed(0))
    tm(torch.rand(128, 128, 3)).sum().backward()
    assert all(p.grad is None for p in tm.backbone.parameters())
    assert tm.final_proj1.weight.grad is not None


def test_build_feature_extractor_shapes_init_and_refusals():
    """Full-width defaults (ViT-B/14, LoRA rank 16 when asked), seeded from
    the config's seed, eval mode; ``patch_embed`` builds the scripts'
    ViT-B/16 patch embedding, seeded too; the token dumper raises."""
    cfg = tcfg.config_from_dict({"model": {"use_dino": True, "dino_model_type": "single_scale"},
                                 "dino_model": {"use_lora": True, "lora_rank": 16}})
    m = tdino.build_feature_extractor(cfg.dino, 128, seed=3, device="cpu")
    again = tdino.build_feature_extractor(cfg.dino, 128, seed=3, device="cpu")
    assert not m.training and m.backbone.cfg.hidden_size == 768
    assert m.backbone.blocks[0].attention.query.lora_a.shape == (768, 16)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                  again.state_dict().values()))
    pos = m.backbone.pos_embed
    assert pos.shape == (1 + 37 * 37, 768) and pos.abs().max() <= 0.04 + 1e-7
    assert 0.9 < m.spatial_pos_embed.std().item() < 1.1
    c = tcfg.config_from_dict({"model": {"use_dino": True, "dino_model_type": "patch_embed"}})
    pe = [tdino.build_feature_extractor(c.dino, 128, seed=3, device="cpu") for _ in range(2)]
    assert not pe[0].training and pe[0].conv_proj.weight.shape == (768, 3, 16, 16)
    assert torch.equal(pe[0].conv_proj.weight, pe[1].conv_proj.weight)
    assert pe[0](torch.rand(128, 128, 3)).shape == (14, 14, 768)
    c = tcfg.config_from_dict({"model": {"use_dino": True, "dino_model_type": "dino_lora"}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdino.build_feature_extractor(c.dino, 128, device="cpu")


@pytest.mark.parametrize("projection", ["reference", "script"])
@pytest.mark.parametrize("invalid_fill", ["zeros", "mean"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_feature_sampler_matches_jax(projection, invalid_fill, align_corners):
    """Points along a few train-view-like rays, some behind or beside the
    feature view: the sampled features to atol 1e-5 (``mean`` takes the
    mean over all sampled features, zero-filled invalid ones included)."""
    c2w = np.asarray(jax_make_scene(jax_scene(), 2, img_size=8, gt_samples=8).poses[1])
    pts = RNG.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    fmap = RNG.standard_normal((9, 9, 16)).astype(np.float32)
    want = np.asarray(jax_trainer_mod._feature_sampler(
        jnp.asarray(fmap), jnp.asarray(c2w), 110.0, 128, 128, align_corners=align_corners,
        invalid_fill=invalid_fill, projection=projection)(jnp.asarray(pts)))
    got = _feature_sampler(_t(fmap), _t(c2w), 110.0, 128, 128, align_corners=align_corners,
                           invalid_fill=invalid_fill, projection=projection)(_t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_nerf_mlp_with_dino_matches_jax():
    """``[PE(pos) | PE(dir) | feats]``, features last: rgb and sigma to
    rel 1e-5 on transplanted params (pos_freq 12, 64 features)."""
    pts = RNG.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    dirs = RNG.standard_normal((64, 3)).astype(np.float32)
    feats = RNG.standard_normal((64, 64)).astype(np.float32)
    jm = jmlp.NeRFMLP(pos_freq=12, dir_freq=4, use_viewdirs=True, dino_dim=64, hidden_dim=128,
                      num_layers=3, sigma_bias_init=0.1)
    params = _np_tree(jm.init(jax.random.key(0), jnp.asarray(pts), jnp.asarray(dirs),
                              jnp.asarray(feats))["params"])
    assert params["trunk_0"]["kernel"].shape == (3 + 72 + 27 + 64, 128)
    w_rgb, w_sigma = jm.apply({"params": params}, jnp.asarray(pts), jnp.asarray(dirs),
                              jnp.asarray(feats))
    tm = NeRFMLP(pos_freq=12, dir_freq=4, use_viewdirs=True, dino_dim=64, hidden_dim=128,
                 num_layers=3)
    tm.load_state_dict(nerf_mlp_from_jax(params))
    g_rgb, g_sigma = tm(_t(pts), _t(dirs), _t(feats))
    # PE phases reach 2^11 * 1.5 rad at pos_freq 12: one ulp of phase is
    # ~2e-4 rad, so the two frameworks' sin/cos differ by up to that much
    np.testing.assert_allclose(g_rgb.detach().numpy(), np.asarray(w_rgb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_sigma.detach().numpy(), np.asarray(w_sigma), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="requires dino"):
        tm(_t(pts), _t(dirs))


# ------------------------------------------------------------------ trainer

RES = 28  # 2x2 patches of 14 for the extractor; feature maps given directly below


def _config(mod, save_dir="unused", **over):
    d = {
        "experiment": {"name": "port-dino"},
        "data": {"resolution": RES, "num_views": 2},
        "model": {"use_dino": True, "dino_model_type": "single_scale"},
        "nerf_model": {"pos_freq": 12, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        # phase 0: 14x14 rays per view in batches of 64 (ragged tail of 4);
        # phase 1: 28x28 in batches of 160 (ragged tail of 16)
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 14, "n_samples": 8, "batch_size": 64},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 160}]},
        "optimizer": {"lr": 2e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 196},
        "output": {"save_dir": save_dir, "val_freq": 1, "save_freq": 1},
        "seed": 0,
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32, split="test")
    # per-view maps (V, 3, 3, 64) as the extractor would give them: O(1) values
    feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    return train, test, feats


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


@pytest.mark.parametrize("backend,invalid_fill,jax_kernels", [
    ("auto", "zeros", True), ("xla", "zeros", True), ("auto", "mean", True),
    ("xla", "zeros", False)])
def test_dino_train_epoch_and_eval_match_jax_trainer(scene, monkeypatch, backend, invalid_fill,
                                                     jax_kernels):
    """Both trainers get the same ``dino_features`` and the same init. The
    JAX trainer runs its train kernel in interpret mode
    (``FORCE_INTERPRET_KERNELS``) and its inline-PE render kernel for eval,
    or (``jax_kernels`` False) its CPU XLA path; the port the kernels' plain
    versions (``auto``) or the plain pipeline (``xla``). Epoch losses within
    rtol 1e-4; eval PSNR within 1e-3 dB and
    the rendered views within 2e-4 (the kernels' cos is ``sin(x + pi/2)``,
    rounded once more than ``cos`` at phases up to 2^11 * 2 rad: ~2.4e-4
    rad on the top band, ROADMAP queue 3); the dead-sigma probe within
    1e-4."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", jax_kernels)
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test, feats = scene
    over = {"dino_model": {"invalid_fill": invalid_fill}}
    jtr = jax_trainer_mod.Trainer(_config(jcfg, **over), train, test, dino_features=feats)
    assert jtr.use_dino and jtr._kernel_eligible() == jax_kernels
    ptr = Trainer(_config(tcfg, rendering={"backend": backend}, **over), _port_data(train),
                  _port_data(test), device="cpu", dino_features=feats)
    assert ptr.use_dino and ptr._use_fused() == (backend == "auto")
    assert ptr.model.trunk[0].weight.shape[1] == 3 + 72 + 27 + 64
    ptr.load_jax_params(_np_tree(jtr.params))
    for epoch in (0, 1):
        np.testing.assert_allclose(ptr.train_epoch(epoch), jtr.train_epoch(epoch), rtol=1e-4)
    assert len(ptr.last_step_losses) == 2 * 5  # 2 views x ceil(784 / 160)
    poses = [np.asarray(test.poses[i]) for i in range(2)]
    got, want = ptr.render_views(poses), jtr.render_views(poses)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-4 if name != "depth" else 2e-3,
                                   err_msg=name)
    assert abs(ptr.evaluate()["psnr"] - jtr.evaluate()["psnr"]) < 1e-3
    assert abs(ptr.dead_sigma_probe() - jtr.dead_sigma_probe()) < 1e-4


def test_dino_features_change_the_render_and_get_no_gradient(scene):
    """The maps condition the MLP (other maps, other views), stay constants,
    and eval uses train view 0's map whatever the pose."""
    train, test, feats = scene
    ptr = Trainer(_config(tcfg), _port_data(train), _port_data(test), device="cpu",
                  dino_features=feats)
    pose = [np.asarray(test.poses[0])]
    base = ptr.render_views(pose)[0]
    ptr.dino_features[1] += 5.0  # view 1's map: not read by eval
    assert np.array_equal(ptr.render_views(pose)[0], base)
    ptr.dino_features[0] += 5.0
    assert not np.allclose(ptr.render_views(pose)[0], base, atol=1e-3)
    ptr.train_epoch(0)
    assert not ptr.dino_features.requires_grad
    plain = Trainer(_config(tcfg, model={"use_dino": False}), _port_data(train), device="cpu",
                    dino_features=feats)
    assert not plain.use_dino and plain.model.trunk[0].weight.shape[1] == 3 + 72 + 27


def test_kernel_vs_plain_path_at_pos_freq_12(scene):
    """The port's kernel path (the plain version of kernel 1: cos as
    ``sin(x + pi/2)``) against its plain pipeline (``cos``) at pos_freq 12
    from the same weights and batches: per-step losses of an epoch within
    rel 1e-4. The derived bound: the extra rounding of ``x + pi/2`` is at
    most half an ulp of the phase, 2^-12 rad at |phase| < 2^12 (the top band
    2^11 times |p| < 2), so each of the 3 top-band inputs moves by <= 2.4e-4
    and the 2^10 band's by <= 1.2e-4; through w0's ~1/sqrt(166) weights a
    pre-activation moves by < 1e-4 and the loss by a smaller relative
    amount (measured: ~1e-6)."""
    train, test, feats = scene
    trainers = [Trainer(_config(tcfg, rendering={"backend": b}), _port_data(train),
                        device="cpu", dino_features=feats) for b in ("auto", "xla")]
    assert [t._use_fused() for t in trainers] == [True, False]
    for t in trainers:
        t.train_epoch(0)
    k, p = (t.last_step_losses for t in trainers)
    np.testing.assert_allclose(k, p, rtol=1e-4)
