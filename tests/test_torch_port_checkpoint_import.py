"""Reference PyTorch checkpoints (``.pth`` / ``.pt``) through
``Trainer.load`` of the port and of the JAX package: modules in the
reference's layouts, built as ``tests/test_torch_import.py`` builds them
(the functional MLP with ``layers.{i}`` Linears or LoRA layers with
``.original`` / ``lora_A`` / ``lora_B``, and the ``NeRFWithDINO``
Sequential stacks), saved under ``nerf_model_state_dict``, under
``nerf_state_dict`` or bare; and ``cli train --resume x.pth``.

Tolerance: both trainers render a test view on their plain pipelines
(``backend: xla`` on the port; the JAX CPU path), ``cos`` computed
directly on both sides: rgb and acc within 1e-5, depth (up to 6) within
1e-4.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn as tnn

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch import cli as tcli
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer
from nerf_fewshot_tpu_torch.utils import torch_import

RES, HIDDEN, N_LAYERS, POS, DIR = 12, 32, 3, 6, 2
IN_DIM = 3 * (2 * POS + 1) + 3 * (2 * DIR + 1)  # PE(pos) | PE(dir)


class RefLoRALinear(tnn.Module):
    """The reference's LoRA layer: ``original`` + ``lora_B(lora_A(x))``."""

    def __init__(self, in_f, out_f, rank=4, alpha=16.0):
        super().__init__()
        self.original = tnn.Linear(in_f, out_f)
        self.lora_A = tnn.Linear(in_f, rank, bias=False)
        self.lora_B = tnn.Linear(rank, out_f, bias=False)
        tnn.init.normal_(self.lora_B.weight, std=0.02)


class RefMLP(tnn.Module):
    """The reference's functional MLP layout: ``layers.{i}`` (dense or LoRA)
    and the ``sigma_out`` / ``rgb_out`` heads."""

    def __init__(self, lora):
        super().__init__()
        dims = [IN_DIM] + [HIDDEN] * N_LAYERS
        self.layers = tnn.ModuleList(
            RefLoRALinear(dims[i], dims[i + 1]) if lora else tnn.Linear(dims[i], dims[i + 1])
            for i in range(N_LAYERS))
        self.sigma_out = tnn.Linear(HIDDEN, 1)
        self.rgb_out = tnn.Linear(HIDDEN, 3)
        with torch.no_grad():
            self.sigma_out.bias.fill_(0.5)


class RefNeRFWithDINO(tnn.Module):
    """The reference module stack's naming (Sequential indices)."""

    def __init__(self, dino_dim=8):
        super().__init__()
        h, pos_dim, dir_dim = HIDDEN, 3 * (2 * POS + 1), 3 * (2 * DIR + 1)
        self.dino_fusion = tnn.Module()
        self.dino_fusion.fusion = tnn.Sequential(tnn.Linear(pos_dim + dino_dim, h), tnn.ReLU(),
                                                 tnn.Linear(h, h), tnn.ReLU())
        self.dino_fusion.attention = tnn.Sequential(tnn.Linear(h, h // 4), tnn.ReLU(),
                                                    tnn.Linear(h // 4, 2), tnn.Softmax(dim=-1))
        self.dino_fusion.output_proj = tnn.Linear(h, h)
        self.density_mlp = tnn.Module()
        self.density_mlp.density_layers = tnn.Sequential(
            *[m for _ in range(N_LAYERS) for m in (tnn.Linear(h, h), tnn.ReLU())])
        self.density_mlp.density_head = tnn.Linear(h, 1)
        self.density_mlp.feature_head = tnn.Linear(h, h)
        self.color_mlp = tnn.Module()
        self.color_mlp.color_layers = tnn.Sequential(
            tnn.Linear(h + dir_dim, h // 2), tnn.ReLU(), tnn.Linear(h // 2, h // 4), tnn.ReLU(),
            tnn.Linear(h // 4, 3), tnn.Sigmoid())
        with torch.no_grad():
            self.density_mlp.density_head.bias.fill_(0.5)


def _config(mod, arch, backend="auto"):
    nerf = {"pos_freq": POS, "dir_freq": DIR, "hidden_dim": HIDDEN, "num_layers": N_LAYERS}
    model = {"use_dino": False}
    if arch == "lora":
        nerf["lora_rank"] = 4
    elif arch == "module":
        nerf["arch"] = "module"
        model = {"use_dino": True, "dino_model_type": "single_scale", "dino_dim": 8}
    return mod.config_from_dict({
        "experiment": {"name": f"import-{arch}"},
        "data": {"resolution": RES, "num_views": 2},
        "model": model,
        "nerf_model": nerf,
        "training": {"epochs": 9, "phases": [{"start": 0, "H": RES, "n_samples": 16,
                                              "batch_size": 144}]},
        "rendering": {"chunk_size": 144, "backend": backend},
        "output": {"save_dir": "unused", "val_freq": 100, "save_freq": 100},
        "seed": 0,
    })


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 1, img_size=RES, gt_samples=32, split="test")
    feats = np.random.default_rng(4).standard_normal((2, 3, 3, 8)).astype(np.float32)
    return train, test, feats


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


@pytest.mark.parametrize("arch,schema", [
    ("lora", "nerf_model_state_dict"), ("lora", "bare"), ("dense", "nerf_model_state_dict"),
    ("dense", "nerf_state_dict"), ("module", "nerf_state_dict")])
def test_reference_checkpoint_renders_as_in_the_jax_trainer(scene, tmp_path, arch, schema):
    train, test, feats = scene
    torch.manual_seed(7)
    ref = RefNeRFWithDINO() if arch == "module" else RefMLP(lora=arch == "lora")
    sd = ref.state_dict()
    path = str(tmp_path / ("ref.pt" if schema == "bare" else "ref.pth"))
    torch.save(sd if schema == "bare" else {schema: sd, "epoch": 7}, path)
    want_epoch = 0 if schema == "bare" else 8

    dino = feats if arch == "module" else None
    jtr = jax_trainer_mod.Trainer(_config(jcfg, arch), train, test, dino_features=dino)
    jtr.load(path)
    ptr = Trainer(_config(tcfg, arch, backend="xla"), _port_data(train), _port_data(test),
                  device="cpu", dino_features=dino)
    before = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    ptr.load(path)
    assert ptr.epoch == jtr.epoch == want_epoch
    assert ptr.optimizer.state == {}  # started afresh
    after = ptr.model.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in after), "a key was not imported"
    if arch == "lora":
        torch.testing.assert_close(after["trunk.1.lora_b"], sd["layers.1.lora_B.weight"].T)
    pose = np.asarray(test.poses[0])
    for g, w, name in zip(ptr.render_view(pose), jtr.render_view(pose), ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=1e-4 if name == "depth" else 1e-5, err_msg=name)
    assert np.asarray(jtr.render_view(pose)[2]).max() > 0.1  # the view is not empty


def test_unmatched_entries_keep_their_values():
    """Entries the reference file lacks keep the model's current values."""
    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP

    model = NeRFMLP(pos_freq=POS, dir_freq=DIR, use_viewdirs=True, hidden_dim=HIDDEN,
                    num_layers=N_LAYERS, lora_rank=4)
    state = model.state_dict()
    sd = {k: v for k, v in RefMLP(lora=False).state_dict().items() if not k.startswith("rgb_out")}
    got = torch_import.import_nerf_mlp_state_dict(state, sd)
    assert torch.equal(got["rgb_head.weight"], state["rgb_head.weight"])
    assert torch.equal(got["trunk.0.lora_a"], state["trunk.0.lora_a"])
    assert torch.equal(got["trunk.0.base.weight"], sd["layers.0.weight"])


def test_cli_resume_from_a_reference_checkpoint(scene, tmp_path, monkeypatch, capsys):
    """``cli train --resume x.pth --device cpu`` goes to ``load_torch``: the
    reference weights, then the epochs left after the file's epoch."""
    ref = RefMLP(lora=True)
    path = str(tmp_path / "ref.pth")
    torch.save({"nerf_model_state_dict": ref.state_dict(), "epoch": 1}, path)
    config = tmp_path / "lora.yaml"
    config.write_text(f"""experiment:
  name: "resume-pth"
data:
  resolution: {RES}
  num_views: 2
model:
  use_dino: false
nerf_model:
  pos_freq: {POS}
  dir_freq: {DIR}
  hidden_dim: {HIDDEN}
  num_layers: {N_LAYERS}
  lora_rank: 4
training:
  epochs: 3
  phases:
    - {{start: 0, H: {RES}, n_samples: 8, batch_size: 144}}
rendering:
  chunk_size: 144
output:
  save_dir: "{tmp_path / 'run'}"
  val_freq: 100
  save_freq: 100
""")
    calls = []
    real = Trainer.load_torch
    monkeypatch.setattr(Trainer, "load_torch",
                        lambda self, p: (calls.append(p), real(self, p))[1])
    tcli.main(["train", "--config", str(config), "--synthetic", "--device", "cpu",
               "--resume", path])
    out = capsys.readouterr().out
    assert calls == [path]
    assert f"[resume] from {path} at epoch 2" in out
    assert json.loads((tmp_path / "run" / "final.ckpt.json").read_text())["epoch"] == 2
