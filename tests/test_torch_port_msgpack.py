"""The port's reader of the JAX package's flax msgpack checkpoints
(``utils/checkpoint.py:read_msgpack``) against
``flax.serialization.msgpack_restore``, and ``Trainer.load`` of a JAX
``.ckpt`` against the JAX trainer's own ``load``.

- The reader: the same tree, bit-equal arrays of the same dtypes, on every
  tracked ``artifacts/*/*.ckpt`` and on trees the test writes (with
  ``to_bytes`` and with ``msgpack.packb`` for every format code).
- ``Trainer.load``: a tracked ``round4b_script_baseline_bias`` checkpoint
  (ViT-B/16 patch-embed features, 831 input columns; both trainers get the
  JAX extractor's feature maps), and checkpoints the JAX trainer writes
  here for a tiny baseline (grad clip and weight decay: two empty states
  in the chain) and a trunk-LoRA config after its freeze (the
  ``multi_transform`` state, masked leaves). Params and Adam moments equal
  the JAX trainer's bit for bit (the port's layouts are transposes), the
  step count, the learning rate, epoch and best PSNR equal; one epoch after
  the load within rtol 1e-4 of the JAX trainer's.
"""

import glob
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import dino as jdino
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer
from nerf_fewshot_tpu_torch.utils.checkpoint import checkpoint_format, read_msgpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = sorted(glob.glob(os.path.join(ROOT, "artifacts", "*", "*.ckpt")))
SCRIPT_CKPT = os.path.join(ROOT, "artifacts", "round4b_script_baseline_bias", "best.ckpt")


def assert_same_tree(got, want, path="tree"):
    """Same keys in the same order, same leaf types; arrays of the same
    dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_the_tracked_checkpoints_are_there():
    assert len(TRACKED) == 24 and SCRIPT_CKPT in TRACKED


@pytest.mark.parametrize("path", TRACKED, ids=lambda p: os.path.relpath(p, ROOT))
def test_reader_equals_msgpack_restore_on_the_tracked_checkpoints(path):
    with open(path, "rb") as f:
        data = f.read()
    assert checkpoint_format(path) == "msgpack"
    assert_same_tree(read_msgpack(data), serialization.msgpack_restore(data))


def test_reader_equals_msgpack_restore_on_written_trees():
    """``to_bytes`` of every leaf kind flax writes, and ``msgpack.packb`` of
    every width of int, str, bin, array and map, float32 and float64."""
    tree = {"int": 7, "neg": -3, "big": 2 ** 40, "float": 2.5, "true": True, "false": False,
            "none": None, "str": "lr", "bytes": b"\x00\xff", "np_scalar": np.float32(3.5),
            "np_int": np.int64(-9), "zero_d": np.array(5, np.int32),
            "arrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "i8": np.array([-1, 2], np.int8), "bool": np.array([True, False]),
                       "empty": np.zeros((0, 4), np.float32), "f64": np.ones(3)},
            "empty": {}, "nested_empty": {"a": {}, "b": {"c": {}}},
            "tuple": (1, np.float32(2.0)), "complex": complex(1.5, -2.0)}
    data = serialization.to_bytes(tree)
    got = read_msgpack(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert got["tuple"] == {"0": 1, "1": np.float32(2.0)} and got["zero_d"].shape == ()

    raw = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
                    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
           "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
           "bins": [b"", b"x" * 300, b"y" * 70000],
           "arrays": [list(range(15)), list(range(16)), list(range(70000))],
           "maps": {str(i): i for i in range(20)}, "floats": [0.1, -1e300]}
    for single in (False, True):
        data = msgpack.packb(raw, use_bin_type=True, use_single_float=single)
        assert read_msgpack(data) == msgpack.unpackb(data, raw=False)
    big_map = msgpack.packb({str(i): None for i in range(70000)})
    assert big_map[0] == 0xDF and read_msgpack(big_map) == msgpack.unpackb(big_map)


def test_reader_raises_on_what_flax_does_not_write():
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})
    with pytest.raises(ValueError, match="chunked"):
        read_msgpack(chunked)
    with pytest.raises(ValueError, match="ext type 9"):
        read_msgpack(msgpack.packb({"a": msgpack.ExtType(9, b"abc")}))
    with pytest.raises(ValueError, match="bytes after"):
        read_msgpack(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        read_msgpack(msgpack.packb({"a": "xyz"})[:-1])
    with pytest.raises(ValueError, match="starts no value"):
        read_msgpack(b"\xc1")


def test_checkpoint_format_by_first_bytes(tmp_path):
    torch.save({"a": torch.zeros(2)}, tmp_path / "port.ckpt")
    (tmp_path / "jax.ckpt").write_bytes(serialization.to_bytes({"params": {"w": np.zeros(2)}}))
    (tmp_path / "big.ckpt").write_bytes(msgpack.packb({str(i): i for i in range(20)}))
    (tmp_path / "text.ckpt").write_text("not a checkpoint")
    assert checkpoint_format(str(tmp_path / "port.ckpt")) == "torch"
    assert checkpoint_format(str(tmp_path / "jax.ckpt")) == "msgpack"
    assert checkpoint_format(str(tmp_path / "big.ckpt")) == "msgpack"
    with pytest.raises(ValueError, match="neither"):
        checkpoint_format(str(tmp_path / "text.ckpt"))


# ----------------------------------------------------------- Trainer.load

def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _jax_adam(state):
    """The ``ScaleByAdamState`` inside a JAX trainer's optimizer state."""
    if hasattr(state, "inner_states"):
        state = state.inner_states["lora"].inner_state
    adam = [s for s in state.inner_state if hasattr(s, "mu")]
    assert len(adam) == 1
    return state, adam[0]


def _masked_to_zeros(moment, params):
    if isinstance(params, dict):
        return {k: _masked_to_zeros(moment[k], v) for k, v in params.items()}
    return np.zeros_like(params) if not hasattr(moment, "shape") else np.asarray(moment)


def assert_loaded_like_jax(ptr, jtr):
    """The port trainer after ``load`` against the JAX trainer after its
    own: params and Adam moments bit for bit, step, lr, epoch, best PSNR."""
    params = jax.tree_util.tree_map(np.asarray, jtr.params)
    for k, v in nerf_mlp_from_jax(params).items():
        assert torch.equal(ptr.model.state_dict()[k], v), k
    inject, adam = _jax_adam(jtr.opt_state)
    mu = nerf_mlp_from_jax(_masked_to_zeros(adam.mu, params))
    nu = nerf_mlp_from_jax(_masked_to_zeros(adam.nu, params))
    names = {id(p): n for n, p in ptr.model.named_parameters()}
    group = ptr.optimizer.param_groups[0]
    assert len(group["params"]) == len(jax.tree_util.tree_leaves(adam.mu))
    for p in group["params"]:
        st = ptr.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[names[id(p)]]), names[id(p)]
        assert torch.equal(st["exp_avg_sq"], nu[names[id(p)]]), names[id(p)]
        assert float(st["step"]) == int(adam.count) > 0
    assert group["lr"] == float(inject.hyperparams["learning_rate"])
    assert (ptr.epoch, ptr.best_psnr) == (jtr.epoch, jtr.best_psnr)


def test_load_of_the_tracked_script_checkpoint_matches_jax():
    """``round4b_script_baseline_bias/best.ckpt`` with its own config at
    two 32x32 views (the params do not depend on the resolution), both
    trainers given the JAX ViT-B/16 patch embedding's maps of the views."""
    with open(os.path.join(os.path.dirname(SCRIPT_CKPT), "config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"].update(resolution=32, num_views=2)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    train = jax_make_scene(jax_scene(), 2, img_size=32, gt_samples=16)
    apply, variables = jdino.build_feature_extractor(jc.dino, 32)
    feats = np.stack([np.asarray(apply(variables, np.asarray(im)))
                      for im in train.white_composited()])
    assert feats.shape == (2, 14, 14, 768)
    jtr = jax_trainer_mod.Trainer(jc, train, dino_features=feats)
    jtr.load(SCRIPT_CKPT)
    ptr = Trainer(tc, _port_data(train), device="cpu", dino_features=feats)
    ptr.load(SCRIPT_CKPT)
    assert ptr.model.trunk[0].weight.shape == (256, 831)
    assert ptr.epoch == 30 and abs(ptr.best_psnr - 10.31286096572876) < 1e-12
    assert_loaded_like_jax(ptr, jtr)


RES = 16


def _tiny(mod, save_dir, **over):
    d = {"experiment": {"name": "port-msgpack"}, "data": {"resolution": RES, "num_views": 2},
         "nerf_model": {"pos_freq": 4, "dir_freq": 2, "hidden_dim": 128, "num_layers": 2,
                        "sigma_bias": 0.1},
         "training": {"epochs": 3, "phases": [
             {"start": 0, "H": RES, "n_samples": 8, "batch_size": 128}]},
         "optimizer": {"lr": 5e-4, "weight_decay": 1e-4, "grad_clip": 0.5},
         "rendering": {"chunk_size": 128, "backend": "xla"},
         "output": {"save_dir": save_dir, "val_freq": 100, "save_freq": 100}, "seed": 0}
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    return jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=16)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


@pytest.mark.parametrize("case", ["baseline", "lora_only"])
def test_load_of_a_jax_written_checkpoint_matches_jax(scene, tmp_path, monkeypatch, case):
    """The JAX trainer trains two epochs (``lora_only``: rank-2 trunk LoRA
    frozen at epoch 1) and saves; the port loads the file (into a trainer
    on the same side of the freeze). Then both train epoch 2 from the
    loaded state, the same batches, without jitter: losses within rtol
    1e-4, params within 1e-5."""
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    over = {} if case == "baseline" else {
        "nerf_model": {"lora_rank": 2, "lora_alpha": 4},
        "optimizer": {"lora_only_after_epoch": 1}}
    jtr = jax_trainer_mod.Trainer(_tiny(jcfg, str(tmp_path), **over), scene)
    for e in (0, 1):
        jtr.epoch = e
        jtr.train_epoch(e)
    jtr.best_psnr = 9.5
    path = str(tmp_path / "jax.ckpt")
    jtr.save(path)
    assert checkpoint_format(path) == "msgpack"
    ptr = Trainer(_tiny(tcfg, str(tmp_path), **over), _port_data(scene), device="cpu")
    if case == "lora_only":
        with pytest.raises(ValueError, match="cannot resume across the freeze"):
            ptr.load(path)
        ptr.train_epoch(1)  # takes the freeze: a LoRA-only optimizer
    ptr.load(path)
    assert ptr.epoch == 2 and ptr._lora_only_active == (case == "lora_only")
    fresh = jax_trainer_mod.Trainer(_tiny(jcfg, str(tmp_path), **over), scene)
    if case == "baseline":  # the JAX restore takes only a state of its own side
        fresh.load(path)
        assert_loaded_like_jax(ptr, fresh)
    else:
        jtr.epoch = 2
        assert_loaded_like_jax(ptr, jtr)
    ptr._np_rng.bit_generator.state = jtr._np_rng.bit_generator.state  # the same batches
    np.testing.assert_allclose(ptr.train_epoch(2), jtr.train_epoch(2), rtol=1e-4)
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    for k, v in ptr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_load_refuses_an_optimizer_state_it_cannot_map(scene, tmp_path):
    jtr = jax_trainer_mod.Trainer(_tiny(jcfg, str(tmp_path)), scene)
    tree = {"params": jtr.params, "opt_state": {"count": np.int32(3), "trace": {}}}
    path = tmp_path / "odd.ckpt"
    path.write_bytes(serialization.to_bytes(tree))
    ptr = Trainer(_tiny(tcfg, str(tmp_path)), _port_data(scene), device="cpu")
    before = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    with pytest.raises(ValueError, match="not the JAX make_optimizer chain"):
        ptr.load(str(path))
    assert all(torch.equal(v, before[k]) for k, v in ptr.model.state_dict().items())
