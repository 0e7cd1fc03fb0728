"""The port's command line (``nerf_fewshot_tpu_torch/cli.py``) against the
JAX package's, on the CPU (``--device cpu``) and cut-down configs written
into ``tmp_path``: the summary JSON's keys, ``final.ckpt``, the CSV log,
``--resume``, ``--profile``, ``--nan-guard``, ``extract-features``,
``evaluate`` and the refusals of what is not ported.

The DINO configs run the full-width ViT-B/14 extractor on 28x28 views (2x2
patches); the NeRF trunks are 2 x 128.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerf_fewshot_tpu_torch import cli as tcli


def _write_config(tmp_path, name, dino=None, log_format="jsonl", epochs=2, val_freq=1):
    model = "  use_dino: false\n" if dino is None else (
        f"  use_dino: true\n  dino_model_type: \"{dino}\"\n")
    text = f"""experiment:
  name: "{name}"
data:
  resolution: 28
  num_views: 2
model:
{model}nerf_model:
  pos_freq: {12 if dino else 10}
  dir_freq: 4
  hidden_dim: 128
  num_layers: 2
  sigma_bias: 0.1
training:
  epochs: {epochs}
  batch_size: 128     # x2 before epoch 50: one 196-ray step per view
  progressive_schedule:
    epochs_0_50: [14, 14, 8]
    epochs_50_100: [28, 28, 8]
    epochs_100_plus: [28, 28, 8]
optimizer:
  lr: 2.0e-4
rendering:
  chunk_size: 392
output:
  save_dir: "{tmp_path / name}"
  val_freq: {val_freq}
  save_freq: 1
  log_format: {log_format}
"""
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def _summary(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_train_summary_keys_equal_the_jax_clis(tmp_path, monkeypatch, capsys):
    """The same config through both CLIs: the same top-level summary keys;
    the port's ``final_metrics`` has the JAX run's keys (``psnr``, ``ssim``
    and ``lpips``, ``lpips_pretrained``, ``lpips_backend``) plus
    ``kernel_path`` and ``kernel_path_reason``."""
    from nerf_fewshot_tpu import cli as jcli

    monkeypatch.setenv("NERF_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    path = _write_config(tmp_path, "plain")
    jcli.main(["train", "--config", path, "--synthetic"])
    want = _summary(capsys.readouterr().out)
    tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert set(got) == set(want) == {"final_metrics", "best_psnr"}
    assert set(want["final_metrics"]) == {"psnr", "ssim", "lpips", "lpips_pretrained",
                                          "lpips_backend"}
    assert set(got["final_metrics"]) == set(want["final_metrics"]) | {"kernel_path",
                                                                      "kernel_path_reason"}
    assert got["final_metrics"]["lpips_pretrained"] is want["final_metrics"]["lpips_pretrained"]
    assert got["final_metrics"]["lpips_backend"] == "torch-random-vgg"
    assert got["final_metrics"]["kernel_path"] == "kernel"
    assert got["best_psnr"] == max(got["best_psnr"], got["final_metrics"]["psnr"])
    assert os.path.exists(tmp_path / "plain" / "final.ckpt")


def test_train_a_dino_config_with_a_csv_log(tmp_path, capsys):
    """single_scale DINO conditioning end to end: features computed once,
    training on the kernel path (the kernels' plain versions here), a
    ``log.csv`` whose header is the first record's sorted keys."""
    path = _write_config(tmp_path, "dino", dino="single_scale", log_format="csv")
    tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert got["final_metrics"]["kernel_path"] == "kernel"
    assert np.isfinite(got["final_metrics"]["psnr"]) and got["best_psnr"] > 0
    out_dir = tmp_path / "dino"
    assert (out_dir / "final.ckpt").exists() and (out_dir / "epoch_2.ckpt").exists()
    lines = (out_dir / "log.csv").read_text().splitlines()
    assert lines[0].split(",") == sorted(["epoch", "train_loss", "lr", "rays_per_sec",
                                          "kernel_path", "kernel_path_reason", "time"])
    assert len(lines) > 3 and lines[1].startswith("0.0,kernel,")


def test_resume_continues_from_the_checkpoint(tmp_path, capsys):
    """``--resume final.ckpt`` restores the weights and the next epoch; the
    run then trains only the epochs left."""
    path = _write_config(tmp_path, "resume", epochs=1)
    tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu"])
    capsys.readouterr()
    ckpt = str(tmp_path / "resume" / "final.ckpt")
    tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu", "--epochs", "2",
               "--resume", ckpt])
    out = capsys.readouterr().out
    assert f"[resume] from {ckpt} at epoch 1" in out
    assert (tmp_path / "resume" / "epoch_2.ckpt").exists()
    assert json.loads((tmp_path / "resume" / "final.ckpt.json").read_text())["epoch"] == 1


def test_profile_writes_a_trace_and_nan_guard_turns_on_anomaly_mode(tmp_path, capsys):
    path = _write_config(tmp_path, "prof", epochs=1)
    trace_dir = tmp_path / "trace"
    try:
        tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu",
                   "--profile", str(trace_dir), "--nan-guard"])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert "[profile] trace written to" in capsys.readouterr().out
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 0


def test_extract_features_writes_the_jax_shape(tmp_path, monkeypatch, capsys):
    """Both CLIs' ``extract-features`` on a single_scale config: an ``.npz``
    with ``features`` of the same (V, Hp, Wp, 64) shape (random-init
    backbones: the values differ)."""
    from nerf_fewshot_tpu import cli as jcli

    monkeypatch.setenv("NERF_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    path = _write_config(tmp_path, "feat", dino="single_scale")
    shapes = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"f{len(shapes)}.npz")
        main(["extract-features", "--config", path, "--synthetic", "--output", out] + extra)
        assert _summary(capsys.readouterr().out) == {"saved": out, "shape": [2, 2, 2, 64]}
        feats = np.load(out)["features"]
        assert np.isfinite(feats).all()
        shapes.append(feats.shape)
    assert shapes[0] == shapes[1] == (2, 2, 2, 64)


def test_train_on_feature_maps_from_a_file(tmp_path, monkeypatch, capsys):
    """``train --features x.npz`` conditions on the file's ``maps`` (as
    ``tools/export_multiscale_maps.py`` writes them) and runs no extractor;
    maps of another shape, or a config without conditioning, are refused."""
    from nerf_fewshot_tpu_torch.training import trainer as trainer_mod

    path = _write_config(tmp_path, "maps", dino="single_scale", epochs=1)
    maps = np.random.default_rng(0).standard_normal((2, 2, 2, 64)).astype(np.float32)
    npz = str(tmp_path / "maps.npz")
    np.savez(npz, maps=maps)
    seen = []
    init = trainer_mod.Trainer.__init__

    def spy(self, *args, dino_features=None, **kw):
        seen.append(dino_features)
        init(self, *args, dino_features=dino_features, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", spy)
    monkeypatch.setattr(tcli, "_precompute_features", lambda *a: pytest.fail("extractor ran"))
    tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu", "--features", npz])
    got = _summary(capsys.readouterr().out)
    assert np.isfinite(got["final_metrics"]["psnr"])
    np.testing.assert_array_equal(seen[0], maps)
    np.savez(npz, maps=maps[..., :32])
    with pytest.raises(SystemExit, match="need \\(2, Hp, Wp, 64\\)"):
        tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu", "--features", npz])
    with pytest.raises(SystemExit, match="conditions on no features"):
        tcli.main(["train", "--config", _write_config(tmp_path, "plain"), "--synthetic",
                   "--device", "cpu", "--features", npz])


@pytest.mark.parametrize("argv", [
    ["train", "--data-parallel"], ["train", "--multihost"], ["train", "--wandb"],
    ["evaluate"], ["bench-scaling"],
], ids=lambda a: a[-1])
def test_what_is_not_ported_raises_naming_its_roadmap_item(tmp_path, argv, capsys,
                                                           monkeypatch):
    """What is not ported raises, naming its ROADMAP item. ``--wandb`` is
    ported: as the JAX CLI, it sets ``output.use_wandb``, and without the
    wandb package the run trains with its JSONL log alone. So are
    ``--data-parallel``, which on the one CPU device trains with no process
    group and prints no ``[mesh]`` line (the JAX CLI with one device), and
    ``--multihost``, here a one-rank Gloo group read from the environment
    (``tests/test_torch_port_parallel.py`` runs two ranks). ``evaluate`` is
    ported: on the run's ``final.ckpt`` it writes ``evaluation.json`` with
    the JAX harness's keys."""
    dp = argv[-1] in ("--data-parallel", "--multihost")
    path = _write_config(tmp_path, "refuse", val_freq=1000 if dp else 1)  # DP: no eval
    args = argv + (["--config", path, "--synthetic", "--device", "cpu"]
                   if argv[0] == "train" else [])
    if argv[0] == "train":
        if argv[1] == "--multihost":
            from nerf_fewshot_tpu_torch.parallel.mesh import free_port

            for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port())),
                         ("WORLD_SIZE", "1"), ("RANK", "0")):
                monkeypatch.setenv(k, v)
        tcli.main(args + ["--epochs", "1"])
        out = capsys.readouterr().out
        assert "final_metrics" in _summary(out)
        mesh_lines = [x for x in out.splitlines() if x.startswith("[mesh]")]
        assert mesh_lines == ([] if argv[1] != "--multihost" else
                              ["[mesh] data-parallel over 1 devices across 1 processes (gloo)"])
        save_dir = tmp_path / "refuse"
        lines = [json.loads(x) for x in (save_dir / "log.jsonl").read_text().splitlines()]
        assert [x["epoch"] for x in lines if "train_loss" in x] == [0]
        assert (save_dir / "final.ckpt").exists()
        return
    if argv == ["evaluate"]:
        tcli.main(["train", "--config", path, "--synthetic", "--device", "cpu", "--epochs", "1"])
        capsys.readouterr()
        out_dir = tmp_path / "eval"
        tcli.main(["evaluate", "--config", path, "--checkpoint",
                   str(tmp_path / "refuse" / "final.ckpt"), "--synthetic", "--device", "cpu",
                   "--output", str(out_dir), "--n-orbit", "2"])
        assert "[eval] PSNR" in capsys.readouterr().out
        got = json.loads((out_dir / "evaluation.json").read_text())
        assert list(got) == ["metrics", "novel_views", "feature_3d_consistency", "depth",
                             "smoothness", "raw_feature_smoothness"]
        assert (out_dir / "novel_01.png").exists()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        tcli.main(args)


def test_a_cuda_request_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write_config(tmp_path, "nocard")
    for argv in (["train", "--config", path, "--synthetic"],
                 ["extract-features", "--config", path, "--synthetic"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def test_load_datasets_reads_a_blender_scene_as_the_jax_cli(tmp_path):
    """A Blender-layout scene on disk (written with the port's
    ``save_blender``): both CLIs' ``_load_datasets`` give the same first
    ``num_views`` train views (``few_shot``), the whole test split, the same
    poses and focal."""
    from nerf_fewshot_tpu import cli as jcli
    from nerf_fewshot_tpu.training import config as jcfg
    from nerf_fewshot_tpu_torch.data.blender import save_blender
    from nerf_fewshot_tpu_torch.training import config as tcfg

    rng = np.random.default_rng(0)
    scene = tmp_path / "data" / "nerf_synthetic" / "lego"
    for split, n in (("train", 4), ("test", 3)):
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        poses[:, :3, 3] = rng.standard_normal((n, 3))
        save_blender(str(scene), split, rng.uniform(0, 1, (n, 16, 16, 3)), poses, 0.69)
    raw = {"data": {"data_root": str(tmp_path / "data"), "num_views": 2, "resolution": 16}}
    want = jcli._load_datasets(jcfg.config_from_dict(raw), synthetic=False)
    got = tcli._load_datasets(tcfg.config_from_dict(raw), synthetic=False, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.poses, w.poses)
        assert (g.H, g.W, g.focal) == (w.H, w.W, w.focal)
    assert got[0].n_views == 2 and got[1].n_views == 3
    assert np.array_equal(got[0].few_shot(1).poses, got[0].poses[:1])
