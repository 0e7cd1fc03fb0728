"""The port's checkpoint analysis harness (``training/evaluate.py``,
``Trainer.evaluate`` with LPIPS, ``cli evaluate``) against the JAX
package's on the CPU.

- A tiny baseline (2 x 128 trunk, pos_freq 10, 28x28 views): the JAX
  trainer saves its init state as a msgpack ``.ckpt``; both CLIs run
  ``evaluate --synthetic`` on it (the port with ``--device cpu``, on its
  kernel path: the kernels' plain versions), and the port's CLI also on a
  checkpoint of its own.
- A tiny ``single_scale`` DINO state (pos_freq 12, 64 features given as the
  same random maps to both trainers; the two packages' random-init ViTs
  differ): ``comprehensive_evaluation`` on both sides, the port on its
  plain pipeline (the kernels' cos as ``sin(x + pi/2)`` moves a pos_freq-12
  phase by up to ~2.4e-4 rad, ROADMAP queue 3, which the view tolerances of
  ``test_torch_port_dino.py`` carry).

Stated tolerances: PSNR 1e-4 dB, SSIM 1e-5, LPIPS rel 1e-4, the
consistency matrix 1e-5, smoothness rel 1e-4, depth statistics rel 1e-4
(abs 1e-4 below a depth of 1: at pos_freq 12 the two packages' plain
pipelines already render depths up to ~1.4e-4 apart, XLA's and torch's sin
and cos differing at phases up to 2^11 * 2 rad, ROADMAP queue 3, and the
minimum depth of a view sits at ~0.19 on a near-empty pixel) and the
foreground fraction within one pixel; the raw-feature grid's valid masks
equal; dumped views within one 8-bit level.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu import cli as jcli
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.ops import rays as jrays
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.training import evaluate as jeval
from nerf_fewshot_tpu_torch import cli as tcli
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.ops import rays as trays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import evaluate as teval
from nerf_fewshot_tpu_torch.training.trainer import Trainer

RES = 28
CONFIG = f"""experiment:
  name: "port-evaluate"
data:
  resolution: {RES}
  num_views: 2
model:
  use_dino: false
nerf_model:
  pos_freq: 10
  dir_freq: 4
  hidden_dim: 128
  num_layers: 2
  sigma_bias: 0.1
training:
  epochs: 1
  batch_size: 196
  progressive_schedule:
    epochs_0_50: [14, 14, 8]
    epochs_50_100: [28, 28, 8]
    epochs_100_plus: [28, 28, 8]
rendering:
  chunk_size: 392
output:
  save_dir: "{{save_dir}}"
"""


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def assert_results_match(got, want, dirs, n_orbit, n_test):
    """``comprehensive_evaluation`` results and output directories of the
    port (``got``, ``dirs[0]``) against the JAX ones, at the stated
    tolerances."""
    assert list(got) == list(want)
    gm, wm = got["metrics"], want["metrics"]
    assert list(gm) == list(wm) == ["psnr", "ssim", "lpips", "lpips_pretrained", "lpips_backend"]
    assert abs(gm["psnr"] - wm["psnr"]) < 1e-4 and abs(gm["ssim"] - wm["ssim"]) < 1e-5
    assert _rel(gm["lpips"], wm["lpips"]) < 1e-4 and gm["lpips"] > 0
    assert (gm["lpips_pretrained"], gm["lpips_backend"]) == (False, "torch-random-vgg")
    assert got["novel_views"] == want["novel_views"] == n_orbit

    gd, wd = got["depth"]["per_view"], want["depth"]["per_view"]
    assert len(gd) == len(wd) == 3
    for g, w in zip(gd, wd):
        assert g["view"] == w["view"]
        for k in ("depth_mean", "depth_std", "depth_min", "depth_max"):
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1.0), (k, g[k], w[k])
        assert abs(g["foreground_fraction"] - w["foreground_fraction"]) <= 1.0 / RES ** 2
    for k in ("sigma_smoothness", "rgb_smoothness"):
        assert _rel(got["smoothness"][k], want["smoothness"][k]) < 1e-4, k

    gc, wc = got["feature_3d_consistency"], want["feature_3d_consistency"]
    gr, wr = got["raw_feature_smoothness"], want["raw_feature_smoothness"]
    if not wc["available"]:
        assert gc == wc == {"available": False} and gr == wr == {"available": False}
    else:
        assert gc["available"] and np.diag(gc["matrix"]).tolist() == [1.0, 1.0]
        np.testing.assert_allclose(gc["matrix"], wc["matrix"], rtol=0, atol=1e-5)
        assert abs(gc["mean_cross_view_similarity"] - wc["mean_cross_view_similarity"]) < 1e-5
        assert list(gr) == list(wr) == ["available", "view_0", "view_1"]
        for v in ("view_0", "view_1"):
            assert gr[v]["n_valid_points"] == wr[v]["n_valid_points"]
            if wr[v]["smoothness_score"] is None:
                assert gr[v]["smoothness_score"] is None
            else:
                assert _rel(gr[v]["smoothness_score"], wr[v]["smoothness_score"]) < 1e-4

    port_dir, jax_dir = dirs
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    n_dump = min(n_test, 5)
    expected = {f"novel_{i:02d}.png" for i in range(n_orbit)} | {
        f"depth_{k}_{i}.png" for k in ("view", "hist_view") for i in range(3)} | {
        f"{k}_{i}.png" for k in ("render", "gt") for i in range(n_dump)} | {"evaluation.json"}
    assert set(names) == expected | ({"consistency_matrix.png"} if wc["available"] else set())
    for name in names:
        if name.startswith(("novel_", "render_", "gt_")):
            a = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
            b = np.asarray(Image.open(os.path.join(jax_dir, name)).convert("RGB"), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    with open(os.path.join(port_dir, "evaluation.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got, default=float))


def test_orbit_poses_match_jax():
    np.testing.assert_allclose(teval.generate_orbit_poses(8), jeval.generate_orbit_poses(8),
                               rtol=0, atol=1e-6)
    poses = teval.generate_orbit_poses(5, radius=3.0, elevation_deg=10.0)
    assert poses.shape == (5, 4, 4) and poses.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(poses[:, :3, 3], axis=1), 3.0, rtol=1e-6)


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_cli_evaluate_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``evaluate --synthetic --n-orbit 3`` through both CLIs on the JAX
    trainer's ``.ckpt`` of the config's init state: exit 0, the ``[eval]`` line
    with the random-VGG caveat, the results JSON as the last line, the same
    ``evaluation.json`` and PNGs at the stated tolerances (the two scenes'
    ground truth differs by fp32 rounding). The port's CLI on a checkpoint
    of its own writes the same keys into ``<save_dir>/evaluation``."""
    monkeypatch.setenv("NERF_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", False)
    path = tmp_path / "ev.yaml"
    path.write_text(CONFIG.format(save_dir=tmp_path / "ev"))
    path = str(path)
    # the init state of the config's model (it does not depend on the views)
    jtr = jax_trainer_mod.Trainer(jcfg.load_config(path),
                                  jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=8))
    jtr.save(str(tmp_path / "jax.ckpt"))

    runs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        main(["evaluate", "--config", path, "--checkpoint", str(tmp_path / "jax.ckpt"),
              "--synthetic", "--output", str(tmp_path / name), "--n-orbit", "3"] + extra)
        out = capsys.readouterr().out
        assert "[eval] PSNR" in out and "random-VGG features: NOT comparable" in out
        runs[name] = _json_lines(out)[-1]
    assert_results_match(runs["port"], runs["jax"], (tmp_path / "port", tmp_path / "jax"),
                         n_orbit=3, n_test=8)

    tc = tcfg.load_config(path)
    Trainer(tc, *tcli._load_datasets(tc, True, "cpu"), device="cpu").save(
        str(tmp_path / "port.ckpt"))
    tcli.main(["evaluate", "--config", path, "--checkpoint", str(tmp_path / "port.ckpt"),
               "--synthetic", "--device", "cpu"])
    own = _json_lines(capsys.readouterr().out)[-1]
    with open(tmp_path / "ev" / "evaluation" / "evaluation.json") as f:
        assert json.load(f) == own
    assert list(own) == list(runs["jax"]) and list(own["metrics"]) == list(runs["jax"]["metrics"])
    assert own["novel_views"] == 8 and len(os.listdir(tmp_path / "ev" / "evaluation")) == 25


def test_evaluate_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "nocard.yaml"
    path.write_text(CONFIG.format(save_dir=tmp_path / "nocard"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["evaluate", "--config", str(path), "--checkpoint", "unused.ckpt",
                   "--synthetic"])


def _dino_config(mod, save_dir, **over):
    d = {"experiment": {"name": "port-evaluate-dino"},
         "data": {"resolution": RES, "num_views": 2},
         "model": {"use_dino": True, "dino_model_type": "single_scale"},
         "nerf_model": {"pos_freq": 12, "dir_freq": 4, "hidden_dim": 128, "num_layers": 2,
                        "sigma_bias": 0.1},
         "training": {"epochs": 1, "phases": [
             {"start": 0, "H": 14, "n_samples": 8, "batch_size": 196}]},
         "rendering": {"chunk_size": 392},
         "output": {"save_dir": save_dir}, "seed": 0}
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


SPLIT_POSE = np.eye(4, dtype=np.float32)
SPLIT_POSE[2, 3] = 3.5  # at z = 3.5 looking down -z: half the raw-feature grid behind it


@pytest.fixture(scope="module")
def dino_scene():
    """Training view 1 seen from ``SPLIT_POSE``: from the scene's own
    cameras every point of the raw-feature grid lies in front, where the
    reference projection's ``z > 0`` test is False (the analysis then reads
    None), from this one 2000 of its 4000 points are valid."""
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    poses = np.array(train.poses)
    poses[1] = SPLIT_POSE
    train = dataclasses.replace(train, poses=poses)
    test = jax_make_scene(jax_scene(), 3, img_size=RES, gt_samples=32, split="test")
    feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    return train, test, feats


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def test_comprehensive_evaluation_of_a_dino_state_matches_jax(dino_scene, tmp_path,
                                                              monkeypatch):
    """The JAX trainer's init state, saved and loaded by the port's
    trainer; both given the same feature maps; ``n_orbit`` 4."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", False)
    train, test, feats = dino_scene
    jtr = jax_trainer_mod.Trainer(_dino_config(jcfg, str(tmp_path)), train, test,
                                  dino_features=feats)
    jtr.save(str(tmp_path / "jax.ckpt"))
    ptr = Trainer(_dino_config(tcfg, str(tmp_path), rendering={"backend": "xla"}),
                  _port_data(train), _port_data(test), device="cpu", dino_features=feats)
    ptr.load(str(tmp_path / "jax.ckpt"))
    want = jeval.comprehensive_evaluation(jtr, str(tmp_path / "jax"), n_orbit=4)
    got = teval.comprehensive_evaluation(ptr, str(tmp_path / "port"), n_orbit=4)
    assert got["feature_3d_consistency"]["available"]
    raw = got["raw_feature_smoothness"]
    assert raw["view_0"]["smoothness_score"] is None and raw["view_1"]["n_valid_points"] == 2000
    assert_results_match(got, want, (tmp_path / "port", tmp_path / "jax"), n_orbit=4, n_test=3)


def test_raw_feature_grid_valid_masks_match_jax(dino_scene):
    """The 20x20x10 grid's projections into both training views: the same
    valid masks (a point flipping between the two packages' fp32 routes
    would move every later pair of the shared ``default_rng(0)`` stream)."""
    train, _, _ = dino_scene
    x, y, z = np.linspace(-2, 2, 20), np.linspace(-2, 2, 20), np.linspace(2.5, 4.5, 10)
    pts = np.stack(np.meshgrid(x, y, z), axis=-1).reshape(-1, 3).astype(np.float32)
    counts = []
    for pose in np.asarray(train.poses):
        _, _, want = jrays.project_points_to_image(pts, pose, train.focal, RES, RES)
        _, _, got = trays.project_points_to_image(torch.from_numpy(pts), torch.from_numpy(pose),
                                                  train.focal, RES, RES)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        counts.append(int(got.sum()))
    assert counts == [0, 2000]
