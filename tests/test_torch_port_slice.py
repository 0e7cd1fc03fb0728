"""The eval/serving slice as a whole: config, synthetic scene, metrics and
``Trainer.render_views`` / ``evaluate`` of the port against the JAX
package, whose Trainer runs its Pallas inline-PE kernel in interpret mode
(``FORCE_INTERPRET_KERNELS``) on the same transplanted weights.
"""

import dataclasses
import glob
import json
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
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.training import metrics as jmetrics
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import metrics as tmetrics
from nerf_fewshot_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("raw")
    return d


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "experiments", "*.yaml"))),
                         ids=os.path.basename)
def test_config_matches_jax_field_by_field(path):
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert _as_dict(tcfg.config_from_dict(raw)) == _as_dict(jcfg.config_from_dict(raw))
    assert _as_dict(tcfg.load_config(path)) == _as_dict(jcfg.load_config(path))


def test_config_validation_matches_jax():
    for bad in ({"rendering": {"backend": "tpu"}},
                {"training": {"phases": [{"start": 5, "n_samples": 8}]}}):
        with pytest.raises(ValueError):
            jcfg.config_from_dict(bad)
        with pytest.raises(ValueError):
            tcfg.config_from_dict(bad)


def test_chip_smoke_baseline_dict_is_baseline_yaml():
    import chip_smoke

    with open(os.path.join(ROOT, "experiments", "baseline.yaml")) as f:
        assert chip_smoke.BASELINE_CONFIG == yaml.safe_load(f)


def test_make_scene_dataset_matches_jax():
    """Same poses exactly; GT images within 2e-5 (sigmoid/exp rounding
    and sum order of a 48-sample composite)."""
    want = jax_make_scene(jax_scene(), 2, img_size=12, gt_samples=48, seed=3, split="test")
    got = make_scene_dataset(lego_like_scene(), 2, img_size=12, gt_samples=48, seed=3,
                             split="test", device="cpu")
    np.testing.assert_array_equal(got.poses, want.poses)
    assert (got.H, got.W, got.focal) == (want.H, want.W, want.focal)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=2e-5)


def test_white_composited_matches_jax():
    from nerf_fewshot_tpu.data.blender import BlenderDataset as JaxDataset

    rgba = np.random.default_rng(2).uniform(0, 1, (2, 5, 5, 4)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    want = JaxDataset(rgba, poses, 5, 5, 10.0).white_composited()
    got = BlenderDataset(rgba, poses, 5, 5, 10.0).white_composited()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"img_size": 6}, {"half_res": True},
                                    {"img_size": 6, "focal_convention": "physical"}])
def test_load_blender_matches_jax(tmp_path, kwargs):
    """A scene written by the port's save_blender loads identically through
    both packages' load_blender."""
    from nerf_fewshot_tpu.data.blender import load_blender as jax_load
    from nerf_fewshot_tpu_torch.data.blender import load_blender, save_blender

    rng = np.random.default_rng(6)
    rgba = rng.uniform(0, 1, (2, 12, 12, 4)).astype(np.float32)
    poses = rng.standard_normal((2, 4, 4)).astype(np.float32)
    save_blender(str(tmp_path), "train", rgba, poses, camera_angle_x=0.6911)
    want = jax_load(str(tmp_path), "train", **kwargs)
    got = load_blender(str(tmp_path), "train", **kwargs)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)
    assert (got.H, got.W, got.focal) == (want.H, want.W, want.focal)
    np.testing.assert_allclose(got.white_composited(), want.white_composited(), atol=1e-6)


@pytest.mark.parametrize("channels", [3, 4])
def test_save_blender_round_trips_through_both_readers(tmp_path, channels):
    """The port's save_blender (PNGs from its own zlib writer) writes what the
    JAX package's does: the PNGs decode to the same pixels, the transforms
    files are equal, and both packages' load_blender read the port's scene
    back as equal datasets, with the written images to 1/255."""
    from PIL import Image

    from nerf_fewshot_tpu.data.blender import load_blender as jax_load
    from nerf_fewshot_tpu.data.blender import save_blender as jax_save
    from nerf_fewshot_tpu_torch.data.blender import load_blender, save_blender

    rng = np.random.default_rng(7)
    images = rng.uniform(-0.1, 1.1, (3, 10, 12, channels)).astype(np.float32)
    poses = rng.standard_normal((3, 4, 4)).astype(np.float32)
    save_blender(str(tmp_path / "port"), "test", images, poses, camera_angle_x=0.6911)
    jax_save(str(tmp_path / "jax"), "test", images, poses, camera_angle_x=0.6911)
    for i in range(3):
        a, b = (np.asarray(Image.open(tmp_path / w / "test" / f"r_{i}.png"))
                for w in ("port", "jax"))
        assert a.shape == (10, 12, channels)
        np.testing.assert_array_equal(a, b)
    meta = [json.loads((tmp_path / w / "transforms_test.json").read_text())
            for w in ("port", "jax")]
    assert meta[0] == meta[1]
    got = load_blender(str(tmp_path / "port"), "test")
    want = jax_load(str(tmp_path / "port"), "test")
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)
    assert (got.H, got.W, got.focal) == (want.H, want.W, want.focal) == (10, 12, got.focal)
    assert got.images.shape == (3, 10, 12, channels)
    np.testing.assert_allclose(got.images, np.clip(images, 0, 1), rtol=0, atol=1 / 255)
    np.testing.assert_array_equal(got.poses, poses)


def test_psnr_ssim_match_jax():
    """fp32 separable window vs the 2-D convolution: 1e-5 on SSIM."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (20, 23, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(tmetrics.psnr(ta, tb)),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.psnr(ta, tb, data_range=None)),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), None)), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.ssim(ta, tb)),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


def _slice_config(mod, **rendering):
    return mod.config_from_dict({
        "experiment": {"name": "port-slice"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128,
                       "num_layers": 3, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [
            {"start": 0, "H": RES, "n_samples": 16, "batch_size": 128}]},
        # 2 test views = 512 rays: chunks of 96 leave a padded last chunk
        "rendering": {"chunk_size": 96, "white_bkgd": False, **rendering},
        "seed": 0,
    })


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32, split="test")
    return train, test


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_trainer_render_views_and_evaluate_match_jax(scene, monkeypatch, backend):
    """The JAX Trainer through its interpret-mode Pallas kernel vs the
    port's Trainer through the fused path's plain version (``auto``) or
    the plain pipeline (``xla``), same weights. Views within the kernel
    test's bound; PSNR to 1e-3 dB, SSIM to 1e-4, LPIPS to rel 1e-4, and
    the JAX trainer's metric keys."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_slice_config(jcfg), train, test)
    assert jtr._use_fused()
    ptr = Trainer(_slice_config(tcfg, backend=backend), _port_data(train), _port_data(test),
                  device="cpu")
    assert ptr._use_fused() == (backend == "auto")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))

    poses = [test.poses[0], test.poses[1], train.poses[0]]
    want = jtr.render_views(poses)
    got = ptr.render_views(poses)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4 if name == "depth" else 2e-5,
                                   err_msg=name)
    rgb1, _, _ = ptr.render_view(poses[1])
    np.testing.assert_array_equal(rgb1, got[0][1])

    m_want = jtr.evaluate()
    m_got = ptr.evaluate()
    assert list(m_got) == list(m_want) == ["psnr", "ssim", "lpips", "lpips_pretrained",
                                           "lpips_backend"]
    assert abs(m_got["psnr"] - m_want["psnr"]) < 1e-3, (m_got, m_want)
    assert abs(m_got["ssim"] - m_want["ssim"]) < 1e-4, (m_got, m_want)
    assert abs(m_got["lpips"] / m_want["lpips"] - 1.0) < 1e-4, (m_got, m_want)
    assert m_got["lpips_pretrained"] is m_want["lpips_pretrained"] is False


def test_trainer_init_is_seeded_and_refuses_unported_work(scene):
    train, test = scene
    a = Trainer(_slice_config(tcfg), _port_data(train), _port_data(test), device="cpu")
    b = Trainer(_slice_config(tcfg), _port_data(train), _port_data(test), device="cpu")
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.model.sigma_head.bias == 0.1)
    raw = _slice_config(tcfg).raw
    # trunk LoRA and the module stack are ported now: they build, seeded
    for ported in ({"nerf_model": {**raw["nerf_model"], "lora_rank": 4}},
                   {"nerf_model": {**raw["nerf_model"], "arch": "module"}}):
        c, d = (Trainer(tcfg.config_from_dict({**raw, **ported}), _port_data(train), device="cpu")
                for _ in range(2))
        assert all(torch.equal(va, vb) for va, vb in zip(c.model.state_dict().values(),
                                                          d.model.state_dict().values()))
    # use_wandb builds too: without the wandb package the log file alone, as the JAX logger
    wandb = {**raw, "output": {**raw.get("output", {}), "use_wandb": True}}
    w = Trainer(tcfg.config_from_dict(wandb), _port_data(train), device="cpu")
    assert w.cfg.output.use_wandb and w.logger._wandb is None
    assert all(torch.equal(va, vb) for va, vb in zip(a.model.state_dict().values(),
                                                      w.model.state_dict().values()))
    with pytest.raises(ValueError, match="backend=fused"):
        cfg = tcfg.config_from_dict({**_slice_config(tcfg).raw,
                                     "nerf_model": {"hidden_dim": 64, "num_layers": 2},
                                     "rendering": {"backend": "fused"}})
        Trainer(cfg, _port_data(train), device="cpu")._use_fused()
    assert not hasattr(tk, "KERNEL_WIDTHS") and tk.H_ALIGN == 128
