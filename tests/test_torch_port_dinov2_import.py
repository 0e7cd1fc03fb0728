"""Pretrained DINOv2 backbones in the port against the JAX package: the
PIL-free processor preprocessor (bit for bit), the HuggingFace weight
mapping and its discovery chain (``$NERF_DINOV2_WEIGHTS``, then the
``$HF_HOME`` hub cache), the ``.safetensors`` reader, ``LoRADINO`` and the
``dino_lora`` token dumper behind ``cli extract-features``.

The state dicts are written by the tests from a seed in HF's key layout
(``chip_smoke.hf_dinov2_state_dict``), at the small ViT of
``test_torch_port_dino.py`` (2 layers, hidden 64, 4 heads, MLP 128, patch
14, the 1370-row position table); nothing is fetched. Tolerances: atol
1e-5 on O(1) LayerNorm-scale outputs, fp32 sums in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import hf_dinov2_state_dict
from nerf_fewshot_tpu.models import dino as jdino
from nerf_fewshot_tpu.models import vit as jvit
from nerf_fewshot_tpu_torch import cli as tcli
from nerf_fewshot_tpu_torch.models import dino as tdino
from nerf_fewshot_tpu_torch.models import vit as tvit
from nerf_fewshot_tpu_torch.models.lora import LoRADense
from nerf_fewshot_tpu_torch.training import config as tcfg

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=14)
HF = "models--facebook--dinov2-base"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tiny_sd(seed):
    return hf_dinov2_state_dict(np.random.default_rng(seed), hidden=64, layers=2, mlp=128)


def _jax_params(module, x, seed):
    """A param tree of ``module`` (its shapes from ``jax.eval_shape``: no
    init to compile) with N(0, 0.05^2) leaves, ``lora_b`` live included."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _hub_file(root, sd, snapshot="0123abc", name="pytorch_model.bin"):
    snap = root / "hub" / HF / "snapshots" / snapshot
    snap.mkdir(parents=True)
    torch.save(sd, str(snap / name))
    return str(snap / name)


def _no_weights(monkeypatch, tmp_path):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_hf_home"))
    monkeypatch.delenv("NERF_DINOV2_WEIGHTS", raising=False)


def _expected_backbone(sd, backbone):
    """The port backbone's state-dict entries the HF dict maps onto, each
    with the file's tensor in the port's shape."""
    want = {"cls_token": sd["embeddings.cls_token"].reshape(1, -1),
            "pos_embed": sd["embeddings.position_embeddings"][0],
            "patch_embed.weight": sd["embeddings.patch_embeddings.projection.weight"],
            "patch_embed.bias": sd["embeddings.patch_embeddings.projection.bias"],
            "norm.weight": sd["layernorm.weight"], "norm.bias": sd["layernorm.bias"]}
    for i, block in enumerate(backbone.blocks):
        hf, ours = f"encoder.layer.{i}", f"blocks.{i}"
        for port, name in (("norm1", "norm1"), ("norm2", "norm2"),
                           ("attention.out", "attention.output.dense"),
                           ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2"),
                           *((f"attention.{p}", f"attention.attention.{p}")
                             for p in ("query", "key", "value"))):
            if isinstance(block.get_submodule(port), LoRADense):
                port += ".base"
            for leaf in ("weight", "bias"):
                want[f"{ours}.{port}.{leaf}"] = sd[f"{hf}.{name}.{leaf}"]
        want[f"{ours}.layerscale1"] = sd[f"{hf}.layer_scale1.lambda1"]
        want[f"{ours}.layerscale2"] = sd[f"{hf}.layer_scale2.lambda1"]
    return want


# ------------------------------------------------------------ preprocessing


@pytest.mark.parametrize("h,w", [(128, 128), (128, 160), (64, 64)])
def test_processor_preprocessor_is_bit_equal_to_the_jax_pil_one(h, w):
    """Bilinear to 224, bicubic to 256 (its overshoot at the edges of pure 0
    and 255 blocks clipped after each pass), crop, the double rescale and
    ImageNet normalisation: every value equal to JAX's Pillow route."""
    x = np.random.default_rng(h + w).uniform(0, 1, (h, w, 3)).astype(np.float32)
    x[: h // 3, : w // 3] = 0.0
    x[h // 2:, w // 2:] = 1.0
    x[h // 3: h // 2, :, 1] = 1.0
    want = jvit.preprocess_dinov2_processor_input(x)
    got = tvit.preprocess_dinov2_processor_input(_t(x)).numpy()
    assert got.shape == want.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # stage 2 may start from stage 1's integers: floor(float32(k / 255) * 255) == k
    k = np.arange(256)
    assert np.array_equal(np.floor((k.astype(np.uint8) / np.float32(255.0)).astype(np.float32)
                                   * np.float32(255.0)), k)


# ------------------------------------------------------------ weight import


@pytest.mark.parametrize("kind", ["single_scale", "multi_scale"])
@pytest.mark.parametrize("lora_rank", [0, 4])
def test_hf_weights_under_hf_home_give_the_jax_features(tmp_path, monkeypatch, kind, lora_rank):
    """Both extractors start from the same transplanted params (their heads
    and spatial embedding are drawn by different RNGs), then each side's
    discovery chain merges the same file under ``$HF_HOME``: the features
    agree within 1e-5 and differ from the random-init ones; every mapped
    tensor equals the file's, every ``lora_*`` tensor is unchanged."""
    img = np.random.default_rng(7).uniform(0, 1, (56, 56, 3)).astype(np.float32)
    jcls, tcls = {"single_scale": (jdino.SpatialDINOFeatures, tdino.SpatialDINOFeatures),
                  "multi_scale": (jdino.MultiScaleDINOFeatures, tdino.MultiScaleDINOFeatures)}[kind]
    kw = {"image_size": 56} if kind == "single_scale" else {}
    jm = jcls(vit=jvit.ViTConfig(**TINY, lora_rank=lora_rank), **kw)
    params = _jax_params(jm, img, 2)
    tm = tcls(vit=tvit.ViTConfig(**TINY, lora_rank=lora_rank), **kw)
    tm.load_state_dict(tdino.dino_extractor_from_jax(params), strict=True)
    tm.eval()
    with torch.no_grad():
        before = tm(_t(img)).numpy()
    lora_before = {k: v.clone() for k, v in tm.state_dict().items() if "lora_" in k}

    sd = _tiny_sd(3)
    sd["some.unknown.key"] = torch.zeros(3)
    _hub_file(tmp_path, sd)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("NERF_DINOV2_WEIGHTS", raising=False)
    variables, merged = jdino._merge_pretrained_backbone({"params": params}, "facebook/dinov2-base")
    assert merged and tdino._merge_pretrained_backbone(tm, "facebook/dinov2-base")
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = tm(_t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - before).max() > 1e-4

    state = tm.backbone.state_dict()
    for key, value in _expected_backbone(sd, tm.backbone).items():
        assert torch.equal(state[key], value), key
    assert len(lora_before) == (6 * TINY["num_layers"] if lora_rank else 0)
    for key, value in lora_before.items():
        assert torch.equal(tm.state_dict()[key], value), key


def test_partial_or_misshaped_dicts_leave_the_init():
    """Only a key present with the right shape is put: a missing layer, a
    misshaped tensor and numpy values (the safetensors reader's) included."""
    vit = tvit.DINOv2ViT(tvit.ViTConfig(**TINY), torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in vit.state_dict().items()}
    sd = {k: v.numpy() for k, v in _tiny_sd(4).items() if not k.startswith("encoder.layer.1.")}
    sd["layernorm.weight"] = np.ones(65, np.float32)
    tvit.load_hf_dinov2_weights(vit, sd)
    state = vit.state_dict()
    assert torch.equal(state["norm.weight"], init["norm.weight"])
    assert torch.equal(state["blocks.1.mlp.fc1.weight"], init["blocks.1.mlp.fc1.weight"])
    assert torch.equal(state["blocks.0.mlp.fc1.weight"], torch.from_numpy(
        sd["encoder.layer.0.mlp.fc1.weight"]))
    assert torch.equal(state["norm.bias"], torch.from_numpy(sd["layernorm.bias"]))


def test_discovery_chain_changes_the_features_and_the_env_var_wins(tmp_path, monkeypatch):
    """``build_feature_extractor``: no file, the random init; a hub snapshot
    under ``$HF_HOME`` (the first of the sorted snapshots), merged with the
    load line printed, changing the features and setting ``cls_token`` to
    the file's; ``$NERF_DINOV2_WEIGHTS`` wins over the hub cache."""
    cfg = tcfg.config_from_dict({"model": {"use_dino": True, "dino_model_type": "single_scale"}})
    vit = tvit.ViTConfig(**TINY)
    img = _t(np.random.default_rng(8).uniform(0, 1, (56, 56, 3)))

    def features():
        m = tdino.build_feature_extractor(cfg.dino, 56, vit=vit, device="cpu")
        with torch.no_grad():
            return m, m(img).numpy()

    _no_weights(monkeypatch, tmp_path)
    assert tvit.find_dinov2_weights() is None
    _, f_random = features()

    sd = _tiny_sd(5)
    path = _hub_file(tmp_path / "hf", sd, snapshot="a1")
    _hub_file(tmp_path / "hf", _tiny_sd(6), snapshot="b2")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert tvit.find_dinov2_weights() == path
    m, f_loaded = features()
    assert f_loaded.shape == f_random.shape == (4, 4, 64) and np.isfinite(f_loaded).all()
    assert np.abs(f_loaded - f_random).max() > 1e-4
    assert torch.equal(m.backbone.cls_token, sd["embeddings.cls_token"].reshape(1, -1))

    direct = tmp_path / "direct.bin"
    sd2 = _tiny_sd(5)
    sd2["layernorm.weight"] = torch.full((64,), 2.0)
    torch.save(sd2, str(direct))
    monkeypatch.setenv("NERF_DINOV2_WEIGHTS", str(direct))
    assert tvit.find_dinov2_weights() == str(direct)
    m, _ = features()
    assert torch.equal(m.backbone.norm.weight, torch.full((64,), 2.0))


def test_safetensors_reader_equals_the_package(tmp_path):
    """``read_safetensors`` against ``safetensors.numpy.load_file`` (F32,
    F16, F64, I64, I32, U8, BOOL, metadata), BF16 against torch's widening,
    and a DINOv2 file in ``.safetensors`` loading as its ``.bin`` twin."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(9)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((4,)).astype(np.float16),
              "f64": rng.standard_normal((2, 2, 2)),
              "i64": rng.integers(-9, 9, (7,)), "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
              "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
              "flag": np.array([True, False, True]), "scalar": np.array(1.5, np.float32)}
    path = str(tmp_path / "a.safetensors")
    st_numpy.save_file(arrays, path, metadata={"format": "np"})
    want = st_numpy.load_file(path)
    got = tvit.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    bf16 = torch.randn(6, 2).to(torch.bfloat16)
    st_torch.save_file({"w": bf16}, str(tmp_path / "b.safetensors"))
    got = tvit.read_safetensors(str(tmp_path / "b.safetensors"))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf16.float().numpy())

    sd = _tiny_sd(10)
    st_torch.save_file(sd, str(tmp_path / "model.safetensors"))
    torch.save(sd, str(tmp_path / "model.bin"))
    a, b = (tvit.DINOv2ViT(tvit.ViTConfig(**TINY), torch.Generator().manual_seed(0))
            for _ in range(2))
    tvit.load_hf_dinov2_weights(a, tvit.load_state_dict_file(str(tmp_path / "model.safetensors")))
    tvit.load_hf_dinov2_weights(b, tvit.load_state_dict_file(str(tmp_path / "model.bin")))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


# ------------------------------------------------------------------ dumper


def test_lora_dino_tokens_match_jax():
    """``LoRADINO`` (rank 4, a live ``lora_b``) on a processor-like input:
    the (1 + 256, hidden) tokens within 1e-5 on transplanted params."""
    x = np.random.default_rng(12).standard_normal((224, 224, 3)).astype(np.float32)
    jm = jdino.LoRADINO(vit=jvit.ViTConfig(**TINY, lora_rank=4))
    params = _jax_params(jm, x, 3)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tdino.LoRADINO(tvit.ViTConfig(**TINY, lora_rank=4))
    tm.load_state_dict(tdino.dino_extractor_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(x)).numpy()
    assert got.shape == want.shape == (257, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cli_extract_features_dumps_the_lora_dino_tokens(tmp_path, monkeypatch, capsys):
    """``cli extract-features`` with ``dino_lora`` on the CPU (2 views at
    32x32, ViT-B/14 with rank-4 LoRA from the config's seed): (2, 256, 768),
    exactly the module's tokens of the preprocessed training views with
    the CLS token dropped."""
    _no_weights(monkeypatch, tmp_path)
    path = tmp_path / "dump.yaml"
    path.write_text(yaml.safe_dump({
        "experiment": {"name": "dump"}, "data": {"resolution": 32, "num_views": 2},
        "model": {"use_dino": True, "dino_model_type": "dino_lora"},
        "output": {"save_dir": str(tmp_path / "out")}, "seed": 3}))
    out = str(tmp_path / "tokens.npz")
    tcli.main(["extract-features", "--config", str(path), "--synthetic", "--device", "cpu",
               "--output", out])
    assert '"shape": [2, 256, 768]' in capsys.readouterr().out
    got = np.load(out)["features"]

    cfg = tcfg.load_config(str(path))
    model = tdino.build_feature_extractor(cfg.dino, 32, seed=3, device="cpu")
    assert isinstance(model, tdino.LoRADINOTokens)
    assert model.backbone.blocks[0].attention.value.lora_a.shape == (768, 4)
    train, _ = tcli._load_datasets(cfg, True, torch.device("cpu"))
    images = np.asarray(train.white_composited(), np.float32)
    with torch.no_grad():
        want = np.stack([model(_t(images[v]))[1:].numpy() for v in range(2)])
    assert got.shape == (2, 256, 768) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert not os.path.exists(tmp_path / "out")
