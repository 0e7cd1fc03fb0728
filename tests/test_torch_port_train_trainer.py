"""The training slice as a whole: ``Trainer.phase_data``, ``train_epoch``,
``dead_sigma_probe``, ``fit``, checkpoints, logs and PNG dumps of the port
against the JAX trainer, whose train step runs its Pallas kernel in
interpret mode (``FORCE_INTERPRET_KERNELS``), on a tiny two-phase schedule.

Both trainers draw their minibatch permutations from
``np.random.default_rng(seed)`` in the same order, so they train on the same
batches; the stratified jitter (JAX threefry vs torch Philox) is switched
off on both sides by patching ``_render_settings`` in the test.
"""

import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.utils import logging as jlogging
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer
from nerf_fewshot_tpu_torch.utils.logging import JSONLLogger, save_png
from nerf_fewshot_tpu_torch.utils.profiling import RateMeter

RES = 16


def _config(mod, save_dir="unused", **over):
    d = {
        "experiment": {"name": "port-train"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        # phase 0: 8x8 rays per view in batches of 48 (ragged tail of 32);
        # phase 1: 16x16 in batches of 96 (ragged tail of 32)
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 128},
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
    return train, test


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


def _updates_close(ptr, start, jparams):
    """The parameter change of the port against the JAX trainer's: as one
    vector within rel 2e-3, each element within 1e-4 (a fifth of lr)."""
    from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax

    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = ptr.model.state_dict()
    for k in start:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    dg = torch.cat([(got[k] - start[k]).reshape(-1) for k in start]).double()
    dw = torch.cat([(want[k] - start[k]).reshape(-1) for k in start]).double()
    assert dw.norm() > 0
    assert ((dg - dw).norm() / dw.norm()).item() < 2e-3


def test_phase_data_matches_jax(scene):
    """Rays to 1e-6 (torch get_rays vs the native C++ one), resized
    targets to 1e-6 (bilinear, align_corners=False, on both sides)."""
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg), train, test)
    ptr = Trainer(_config(tcfg), _port_data(train), _port_data(test), device="cpu")
    for i in range(2):
        want, got = jtr.phase_data(i), ptr.phase_data(i)
        assert (got.H, got.W) == (want.H, want.W)
        for name in ("rays_o", "rays_d", "targets"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    assert ptr.phase_data(0) is ptr.phase_data(0)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_train_epoch_matches_jax_trainer(scene, monkeypatch, backend):
    """Two epochs (one per phase) from the same transplanted init: the JAX
    trainer through its interpret-mode train kernel, the port through the
    kernel's plain version (``auto``) or the plain pipeline (``xla``).
    Epoch losses within rtol 1e-4 (fp32 sums in other orders; measured
    ~1e-6). The parameter change after 10 Adam steps of lr 5e-4 within rel
    2e-3 (measured 2.6e-4): Adam's g/sqrt(v) turns fp32 gradient rounding
    into update differences of order lr wherever a gradient is near zero;
    the f64 loop gate pins the exact semantics."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg), train, test)
    assert jtr._kernel_eligible()
    ptr = Trainer(_config(tcfg, rendering={"backend": backend}), _port_data(train),
                  _port_data(test), device="cpu")
    assert ptr._use_fused() == (backend == "auto")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    for epoch in (0, 1):
        want = jtr.train_epoch(epoch)
        got = ptr.train_epoch(epoch)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(ptr.last_step_losses) == 2 * 3  # 2 views x ceil(256 / 96) steps
    _updates_close(ptr, start, jtr.params)
    assert abs(ptr.dead_sigma_probe() - jtr.dead_sigma_probe()) < 1e-4
    assert ptr.dead_sigma_probe() > 0


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_rgb_weight_matches_the_jax_cpu_trainer(scene, monkeypatch, backend):
    """``loss.rgb_weight`` 0.5: the JAX trainer on the CPU trains on XLA,
    which applies the weight (its TPU kernel path would not); the port
    applies it on the kernel path (the objective's ``rgb_c``, ``auto``) as on
    the plain one (``xla``). Epoch losses within rtol 1e-4 and the parameter
    change within the bounds of ``test_train_epoch_matches_jax_trainer``."""
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg, loss={"rgb_weight": 0.5}), train, test)
    assert not jtr._kernel_eligible()  # no TPU: XLA
    ptr = Trainer(_config(tcfg, loss={"rgb_weight": 0.5}, rendering={"backend": backend}),
                  _port_data(train), _port_data(test), device="cpu")
    assert ptr._use_fused() == (backend == "auto")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    for epoch in (0, 1):
        np.testing.assert_allclose(ptr.train_epoch(epoch), jtr.train_epoch(epoch), rtol=1e-4)
    _updates_close(ptr, start, jtr.params)


def test_rgb_weight_scales_the_kernel_objective():
    """The objective at rgb_weight w is w times the one at 1 (no other
    term), loss and gradients."""
    train = jax_make_scene(jax_scene(), 1, img_size=8, gt_samples=16)
    ptr = Trainer(_config(tcfg), _port_data(train), device="cpu")
    pd = ptr.phase_data(0)
    ro, rd, tgt = pd.rays_o[0][:16], pd.rays_d[0][:16], pd.targets[0][:16]
    settings = ptr._render_settings(8, training=False)
    out = {}
    for w in (1.0, 0.5):
        out[w] = tt.fused_train_loss_grad(ptr.model, ro, rd, tgt, torch.ones(16), settings,
                                          10, 4, 3, 128, rgb_weight=w)
    np.testing.assert_allclose(float(out[0.5][0]), 0.5 * float(out[1.0][0]), rtol=1e-6)
    for k, g in out[0.5][1].items():
        torch.testing.assert_close(g, 0.5 * out[1.0][1][k], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("name", ["HIERARCHICAL_CONFIG", "SMOKE_CONFIG"])
def test_chip_smoke_config_dicts_are_the_yaml_files(name):
    """The card has no yaml: chip_smoke carries these configs as literal
    dicts, held equal to the files here."""
    import os

    import chip_smoke
    import yaml

    path = {"HIERARCHICAL_CONFIG": "hierarchical.yaml", "SMOKE_CONFIG": "smoke.yaml"}[name]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "experiments", path)) as f:
        assert getattr(chip_smoke, name) == yaml.safe_load(f)


def test_kernel_path_launches_nothing_on_the_cpu(scene):
    """On the CPU the train step runs the kernel's plain version."""
    train, test = scene
    ptr = Trainer(_config(tcfg), _port_data(train), _port_data(test), device="cpu")
    before = dict(tt.fused_train_objective.launches)
    ptr.train_epoch(0)
    assert tt.fused_train_objective.launches == before
    assert np.isfinite(ptr.last_step_losses).all() and len(ptr.last_step_losses) == 4


def _read_png(path):
    """Decode an 8-bit RGB PNG written with filter 0 on every row."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    W, H, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(H, 1 + 3 * W)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(H, W, 3)


def test_save_png_writes_the_pixels_the_jax_package_writes(tmp_path):
    img = np.random.default_rng(2).uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    save_png(str(tmp_path / "a" / "x.png"), img)
    got = _read_png(tmp_path / "a" / "x.png")
    np.testing.assert_array_equal(got, np.clip(img * 255.0, 0, 255).astype(np.uint8))
    jlogging.save_png(str(tmp_path / "y.png"), img)  # PIL, where it is installed
    from PIL import Image

    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "y.png")))
    with pytest.raises(ValueError):
        save_png(str(tmp_path / "z.png"), img[..., 0])


def _unfit_config(unfit, backend):
    """The tiny config made unfit for the kernels: a trunk width the JAX
    kernels do not take (64), sigma noise (outside the strict reference
    behavior); or past a cap the port's kernels once had and take now: a
    width past 512 (640, the width-generic build), a phase of 1025 samples
    per ray (in phase 1 only), a 16-layer trunk."""
    raw = _config(tcfg).raw
    phases = [dict(p) for p in raw["training"]["phases"]]
    phases[1]["n_samples"] = 1025
    over = {"narrow": {"nerf_model": {**raw["nerf_model"], "hidden_dim": 64}},
            "noisy": {"strict_reference_behavior": False,
                      "rendering": {**raw["rendering"], "noise_std": 1.0}},
            "wide": {"nerf_model": {**raw["nerf_model"], "hidden_dim": 640}},
            "many_samples": {"training": {**raw["training"], "phases": phases}},
            "deep": {"nerf_model": {**raw["nerf_model"], "num_layers": 16}}}[unfit]
    d = {**raw, **over}
    d["rendering"] = {**d["rendering"], "backend": backend}
    return tcfg.config_from_dict(d)


@pytest.mark.parametrize("unfit", ["narrow", "noisy", "wide", "many_samples", "deep"])
@pytest.mark.parametrize("backend", ["auto", "fused", "xla"])
def test_configs_the_kernels_cannot_take(scene, unfit, backend):
    """The path follows the JAX trainer. A config the JAX kernels do not
    take (``narrow``, ``noisy``) trains on the plain path under ``auto`` on
    every device, with the JAX trainer's reason in ``kernel_path_reason``,
    and raises under ``fused``. The width, samples and depth the port's
    kernels once refused (``wide``, ``many_samples``, ``deep``) take the
    kernel path under ``auto`` and ``fused``, on the CPU and as the choice
    a card makes (checked with the trainer's device set to cuda: the choice
    is made before any tensor is); ``xla`` keeps the plain path. No config
    the JAX kernels take is refused: the trainer has no port gap left."""
    train, _ = scene
    ptr = Trainer(_unfit_config(unfit, backend), _port_data(train), device="cpu")
    jax_reason = {"narrow": "hidden_dim=64 not 128-lane aligned",
                  "noisy": "sigma noise_std != 0 is not implemented in the kernels",
                  "wide": None, "many_samples": None, "deep": None}[unfit]
    lifted = unfit in ("wide", "many_samples", "deep")
    assert not hasattr(ptr, "_port_gap_reason")
    if lifted:
        assert ptr._jax_ineligible_reason() is None
    if lifted and backend != "xla":
        assert ptr._use_fused() is True
        assert (ptr.kernel_path, ptr.kernel_path_reason) == ("kernel", None)
        before = tt.fused_train_objective.launches["train_pe"]
        assert np.isfinite(ptr.train_epoch(0))
        assert tt.fused_train_objective.launches["train_pe"] == before  # the CPU: no launch
    elif backend == "fused":
        with pytest.raises(ValueError, match="backend=fused rejected on cpu"):
            ptr.train_epoch(0)
    else:
        assert ptr._use_fused() is False
        assert ptr.kernel_path == "plain"
        if backend == "auto" and jax_reason:
            assert ptr.kernel_path_reason == jax_reason
        if unfit != "noisy":
            assert np.isfinite(ptr.train_epoch(0))
    ptr.device = torch.device("cuda", 0)
    if backend == "xla" or (backend == "auto" and jax_reason):
        assert ptr._use_fused() is False
        assert ptr.kernel_path == "plain"
    elif lifted:
        assert ptr._use_fused() is True and ptr.kernel_path == "kernel"
    else:
        with pytest.raises(ValueError, match=f"backend={backend} rejected on cuda"):
            ptr._use_fused()


def test_logger_and_rate_meter_match_jax(tmp_path):
    recs = [{"epoch": 0, "train_loss": 0.5, "time": 1.0}, {"epoch": 1, "train_loss": 0.25,
                                                           "time": 2.0}]
    pj, pt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jl, tl = jlogging.JSONLLogger(str(pj)), JSONLLogger(str(pt))
    for r in recs:
        jl.log(r)
        tl.log(r)
    jl.close()
    tl.close()
    assert pt.read_text() == pj.read_text()
    # use_wandb without the wandb package: the file sink alone, as the JAX logger
    pj, pt = tmp_path / "jw.jsonl", tmp_path / "tw.jsonl"
    jl = jlogging.JSONLLogger(str(pj), use_wandb=True, run_name="w", config={"a": 1})
    tl = JSONLLogger(str(pt), use_wandb=True, run_name="w", config={"a": 1})
    assert jl._wandb is None and tl._wandb is None
    for r in recs:
        jl.log(r)
        tl.log(r)
    jl.close()
    tl.close()
    assert pt.read_text() == pj.read_text()
    # the CSV sink: the header from the first record, the same rows
    cj, ct = tmp_path / "j.csv", tmp_path / "t.csv"
    jl, tl = jlogging.JSONLLogger(str(cj)), JSONLLogger(str(ct))
    for r in recs + [{"epoch": 1, "psnr": 9.5, "time": 3.0}]:
        jl.log(r)
        tl.log(r)
    jl.close()
    tl.close()
    assert ct.read_text() == cj.read_text()
    assert ct.read_text().splitlines()[0] == "epoch,time,train_loss"
    m = RateMeter(alpha=0.5)
    assert m.update(100, 2.0) == 50.0 and m.update(100, 1.0) == 75.0


def test_fit_writes_logs_images_and_checkpoints_and_load_restores(scene, tmp_path):
    train, test = scene
    save_dir = tmp_path / "run"
    cfg = _config(tcfg, save_dir=str(save_dir))
    ptr = Trainer(cfg, _port_data(train), _port_data(test), device="cpu",
                  log_path=str(tmp_path / "log.jsonl"))
    metrics = ptr.fit()
    assert set(metrics) == {"psnr", "ssim", "lpips", "lpips_pretrained", "lpips_backend",
                            "kernel_path", "kernel_path_reason"}
    assert np.isfinite(metrics["psnr"]) and metrics["lpips"] > 0
    assert (metrics["kernel_path"], metrics["kernel_path_reason"]) == ("kernel", None)
    assert ptr.epoch == 1 and ptr.best_psnr >= metrics["psnr"]

    lines = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    train_lines = [x for x in lines if "train_loss" in x]
    assert [x["epoch"] for x in train_lines] == [0, 1]
    assert all(x["rays_per_sec"] > 0 and x["lr"] == 5e-4 for x in train_lines)
    assert all(x["kernel_path"] == "kernel" for x in train_lines)
    assert [x["epoch"] for x in lines if "psnr" in x] == [0, 1]

    for epoch in (0, 1):
        for i in range(2):
            rgb = _read_png(save_dir / f"epoch_{epoch}" / f"render_{i}.png")
            gt = _read_png(save_dir / f"epoch_{epoch}" / f"gt_{i}.png")
            assert rgb.shape == gt.shape == (RES, RES, 3)
    want_gt = np.clip(np.asarray(test.white_composited()[1]) * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(save_dir / "epoch_1" / "gt_1.png"), want_gt)
    rendered, _, _ = ptr.render_views([test.poses[0]])
    np.testing.assert_array_equal(_read_png(save_dir / "epoch_1" / "render_0.png"),
                                  np.clip(rendered[0] * 255.0, 0, 255).astype(np.uint8))
    for name in ("best.ckpt", "epoch_1.ckpt", "epoch_2.ckpt"):
        assert (save_dir / name).exists() and (save_dir / f"{name}.json").exists()
    assert json.loads((save_dir / "epoch_2.ckpt.json").read_text())["epoch"] == 1

    other = Trainer(cfg, _port_data(train), _port_data(test), device="cpu")
    other.load(str(save_dir / "epoch_2.ckpt"))
    assert other.epoch == 2
    for (k, a), b in zip(ptr.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = ptr.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["state"][k][name]), (k, name)


def test_trainer_refuses_unported_training_options(scene, tmp_path):
    """``output.use_wandb: true`` is no longer refused: without the wandb
    package the port's trainer, as the JAX one, trains with its JSONL sink
    alone, and writes the JAX trainer's records (epoch by epoch, every key
    of the JAX train record; the eval records' PSNR and SSIM)."""
    train, test = scene
    logs = {}
    for side, mod in (("jax", jcfg), ("port", tcfg)):
        cfg = _config(mod, save_dir=str(tmp_path / side), output={"use_wandb": True})
        path = str(tmp_path / f"{side}.jsonl")
        if side == "jax":
            tr = jax_trainer_mod.Trainer(cfg, train, test, log_path=path)
        else:
            tr = Trainer(cfg, _port_data(train), _port_data(test), device="cpu", log_path=path)
        assert tr.cfg.output.use_wandb and tr.logger._wandb is None
        tr.fit()
        logs[side] = [json.loads(x) for x in (tmp_path / f"{side}.jsonl").read_text().splitlines()]
    assert len(logs["port"]) == len(logs["jax"]) == 4
    for want, got in zip(logs["jax"], logs["port"]):
        assert got["epoch"] == want["epoch"]
        keys = set(want) if "train_loss" in want else {"psnr", "ssim"}
        assert keys <= set(got), (sorted(want), sorted(got))
