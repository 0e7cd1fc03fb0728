"""DINOv2-style ViT backbone with LoRA-injectable q/k/v, the standalone
scripts' ViT-B/16 patch embedding, both preprocessors and the pretrained
weight chain (counterpart of ``nerf_fewshot_tpu/models/vit.py``:
``ViTConfig``, ``Attention``, ``MLP``, ``Block``, ``_interpolate_pos_embed``,
``DINOv2ViT``, ``normalize_image``, ``ViTPatchEmbed``,
``preprocess_vit_b16_input``, ``preprocess_dinov2_processor_input``,
``load_torchvision_patch_embed``, ``find_torchvision_vit_b16_weights``,
``find_dinov2_weights``, ``load_state_dict_file``,
``load_hf_dinov2_weights``).

The layout is DINOv2's: a VALID patch-embedding conv (patch 14, stride 14),
a CLS token, the 37x37 position table of the 518-pixel pretraining grid
resized bilinearly to the image's patch grid, pre-LN blocks (exact GELU MLP,
LayerScale), a final LayerNorm; LayerNorm eps 1e-6. Attention and every
product are plain torch ops in the JAX order of operations.

The patch conv is computed as a product of the flattened patches with the
conv weight, exact fp32 on every device (cuDNN would take TF32 by
default); its weight keeps ``nn.Conv2d``'s (E, 3, p, p) layout. No weights
are in the repository: a backbone runs from its seeded random init unless
``find_dinov2_weights`` finds a HuggingFace ``facebook/dinov2-base`` state
dict already on disk (``$NERF_DINOV2_WEIGHTS``, then the ``$HF_HOME`` hub
cache), which ``load_hf_dinov2_weights`` maps in (``.bin`` through
``torch.load``, ``.safetensors`` through the package's own reader).
``vit_from_jax`` carries a JAX param tree across.

``ViTPatchEmbed`` is torchvision ``vit_b_16``'s ``conv_proj`` alone (3 ->
768, kernel and stride 16), the scripts' feature source, on the input of
``preprocess_vit_b16_input``. Both preprocessors run without PIL (the card
machine has none): Pillow's fixed-point bilinear and bicubic resampling of
uint8 pixels, reproduced in integer torch operations bit for bit.
``find_torchvision_vit_b16_weights`` reads only a checkpoint already on
disk.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_fewshot_tpu_torch.models.lora import LoRADense, torch_dense
from nerf_fewshot_tpu_torch.ops.interp import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 14
    layernorm_eps: float = 1e-6
    use_layerscale: bool = True  # DINOv2 blocks carry LayerScale
    layerscale_init: float = 1.0
    lora_rank: int = 0
    lora_alpha: float = 16.0
    base_image_size: int = 518  # DINOv2 pretraining grid (37x37 patches)


def trunc_normal(shape, std: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``truncated_normal(std)``: N(0, std^2) cut at +-2 std."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def _maybe_lora(cfg: ViTConfig, features: int, generator) -> nn.Module:
    if cfg.lora_rank > 0:
        return LoRADense(features, features, rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                         generator=generator)
    return torch_dense(features, features, generator)


class Attention(nn.Module):
    """Multi-head self-attention over (T, E) tokens; q/k/v through
    ``LoRADense`` when ``cfg.lora_rank > 0``."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        E = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = _maybe_lora(cfg, E, generator)
        self.key = _maybe_lora(cfg, E, generator)
        self.value = _maybe_lora(cfg, E, generator)
        self.out = torch_dense(E, E, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, E = x.shape
        H = self.num_heads
        hd = E // H
        q = self.query(x).reshape(T, H, hd).transpose(0, 1)  # (H, T, hd)
        k = self.key(x).reshape(T, H, hd).transpose(0, 1)
        v = self.value(x).reshape(T, H, hd).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
        out = (att @ v).transpose(0, 1).reshape(T, E)
        return self.out(out)


class MLP(nn.Module):
    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.fc1 = torch_dense(cfg.hidden_size, cfg.mlp_dim, generator)
        self.fc2 = torch_dense(cfg.mlp_dim, cfg.hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    """Pre-LN transformer block with LayerScale."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        E = cfg.hidden_size
        self.use_layerscale = cfg.use_layerscale
        self.norm1 = nn.LayerNorm(E, eps=cfg.layernorm_eps)
        self.attention = Attention(cfg, generator)
        self.norm2 = nn.LayerNorm(E, eps=cfg.layernorm_eps)
        self.mlp = MLP(cfg, generator)
        if cfg.use_layerscale:
            self.layerscale1 = nn.Parameter(torch.full((E,), float(cfg.layerscale_init)))
            self.layerscale2 = nn.Parameter(torch.full((E,), float(cfg.layerscale_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attention(self.norm1(x))
        if self.use_layerscale:
            h = h * self.layerscale1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.use_layerscale:
            h = h * self.layerscale2
        return x + h


def _interpolate_pos_embed(pos: torch.Tensor, n_side: int) -> torch.Tensor:
    """The (1 + S^2, E) position table resized to (1 + n_side^2, E): the
    patch part bilinearly (``align_corners=False``), CLS passed through."""
    cls_pos, patch_pos = pos[:1], pos[1:]
    s = int(np.sqrt(patch_pos.shape[0]))
    if s == n_side:
        return pos
    grid = resize_bilinear(patch_pos.reshape(s, s, -1), n_side, n_side, align_corners=False)
    return torch.cat([cls_pos, grid.reshape(n_side * n_side, -1)], dim=0)


def _lecun_conv(out_ch: int, p: int, generator: Optional[torch.Generator]) -> nn.Conv2d:
    """A VALID stride-p ``nn.Conv2d(3, out_ch, p)`` initialised as flax
    ``nn.Conv``: the kernel lecun-normal over (p, p, 3, out_ch), drawn from
    ``generator`` on the CPU, the bias zero."""
    conv = nn.utils.skip_init(nn.Conv2d, 3, out_ch, p, stride=p)
    fan_in = 3 * p * p
    with torch.no_grad():
        conv.weight.copy_(trunc_normal((p, p, 3, out_ch),
                                       math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                                       generator).permute(3, 2, 0, 1))
        conv.bias.zero_()
    return conv


def _patch_product(image: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A VALID stride-p conv of an (H, W, 3) image as the (Hp, Wp, E)
    product of its flattened patches ((kh, kw, c) order) with the kernel in
    that order, exact fp32 on every device; the last H % p rows and W % p
    columns drop."""
    H, W, _ = image.shape
    E, _, p, _ = conv.weight.shape
    Hp, Wp = H // p, W // p
    patches = image[:Hp * p, :Wp * p].reshape(Hp, p, Wp, p, 3).permute(0, 2, 1, 3, 4)
    kernel = conv.weight.permute(2, 3, 1, 0).reshape(p * p * 3, E)
    return (patches.reshape(Hp * Wp, p * p * 3) @ kernel + conv.bias).reshape(Hp, Wp, E)


class DINOv2ViT(nn.Module):
    """Backbone over one ImageNet-normalized (H, W, 3) image: the token
    sequence (1 + Hp*Wp, hidden) after the final LayerNorm, CLS first.
    Parameters are drawn from ``generator`` on the CPU: the conv kernel
    lecun-normal and its bias zero (flax ``nn.Conv``), CLS and position
    table truncated-normal 0.02, the dense layers torch's default."""

    def __init__(self, cfg: ViTConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        E, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = _lecun_conv(E, p, generator)
        self.cls_token = nn.Parameter(trunc_normal((1, E), 0.02, generator))
        base_side = cfg.base_image_size // p
        self.pos_embed = nn.Parameter(trunc_normal((1 + base_side * base_side, E), 0.02,
                                                   generator))
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(E, eps=cfg.layernorm_eps)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        grid = _patch_product(image, self.patch_embed)
        Hp, Wp, E = grid.shape
        tokens = torch.cat([self.cls_token, grid.reshape(Hp * Wp, E)], dim=0)
        tokens = tokens + _interpolate_pos_embed(self.pos_embed, Hp)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an (H, W, 3) [0, 1] image."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
    std = torch.as_tensor(IMAGENET_STD, device=image.device)
    return (image - mean) / std


class ViTPatchEmbed(nn.Module):
    """torchvision ViT-B/16's patch-embedding conv alone (``conv_proj``: 3 ->
    768, kernel 16, stride 16, VALID), the standalone scripts' feature
    source: on a ``preprocess_vit_b16_input`` image (224, 224, 3), the
    (14, 14, 768) grid; no CLS token, position table or blocks. Computed
    as the exact fp32 patch product (``F.conv2d`` would take cuDNN's TF32
    on a card); initialised as flax ``nn.Conv`` from ``generator``."""

    def __init__(self, hidden_dim: int = 768, patch_size: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_proj = _lecun_conv(hidden_dim, patch_size, generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return _patch_product(image, self.conv_proj)


PIL_PRECISION_BITS = 22  # Pillow's fixed-point weights of 8-bit resampling (32 - 8 - 2)


def _pil_bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _pil_bicubic(x: float) -> float:
    """Pillow's bicubic convolution, ``a = -0.5``."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


# Pillow's resampling filters: (filter, support)
PIL_BILINEAR = (_pil_bilinear, 1.0)
PIL_BICUBIC = (_pil_bicubic, 2.0)


def _pil_taps(in_size: int, out_size: int, filt) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's taps of one axis for ``filt`` (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): per output index its first input index and
    up to ``ksize`` fixed-point weights, rounded away from zero. Computed in
    Python doubles in Pillow's order of operations. Returns ``(index (out,
    ksize), weight (out, ksize))``, int64; taps past the window have weight
    0 (their index clamped into the axis)."""
    fn, filter_support = filt
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in ws:
            total += w
        for x, w in enumerate(ws):
            w = w / total if total != 0.0 else w
            weight[i, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << PIL_PRECISION_BITS))
        index[i] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return index, weight


def _pil_resample(u8: torch.Tensor, size: int, axis: int, filt) -> torch.Tensor:
    """One of Pillow's passes of an integer (H, W, 3) image along ``axis``
    (1: the x axis, 0: y) to ``size``: ``clip((2^21 + sum w_j u_j) >> 22, 0,
    255)`` in int64 (the clip takes a bicubic overshoot back to 0..255)."""
    index, weight = (torch.as_tensor(a, device=u8.device)
                     for a in _pil_taps(u8.shape[axis], size, filt))
    taps = torch.index_select(u8, axis, index.reshape(-1))
    if axis == 1:  # (H, out*k, 3) -> (H, out, k, 3)
        taps = taps.reshape(u8.shape[0], size, -1, 3)
        acc = torch.sum(taps * weight[None, :, :, None], dim=2)
    else:  # (out*k, W, 3) -> (out, k, W, 3)
        taps = taps.reshape(size, -1, u8.shape[1], 3)
        acc = torch.sum(taps * weight[:, :, None, None], dim=1)
    acc = (acc + (1 << (PIL_PRECISION_BITS - 1))) >> PIL_PRECISION_BITS
    return torch.clamp(acc, 0, 255)


def _pil_resize(u8: torch.Tensor, size: int, filt) -> torch.Tensor:
    """Pillow's ``resize((size, size), filt)`` of an integer (H, W, 3) image:
    the x pass, then the y pass, each only where that size changes."""
    if u8.shape[1] != size:
        u8 = _pil_resample(u8, size, 1, filt)
    if u8.shape[0] != size:
        u8 = _pil_resample(u8, size, 0, filt)
    return u8


def _to_u8(image01: torch.Tensor) -> torch.Tensor:
    """``ToPILImage``'s ``uint8(clip(x, 0, 1) * 255)`` (truncation), as int64."""
    return (torch.clamp(image01, 0.0, 1.0) * 255.0).to(torch.uint8).to(torch.int64)


def preprocess_vit_b16_input(image01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """The standalone scripts' transform of an (H, W, 3) [0, 1] float32
    image, as the JAX function computes it through PIL, in torch on the
    image's device: ``uint8(clip(x, 0, 1) * 255)`` (truncation, as
    ``ToPILImage``), Pillow's bilinear resize to (size, size) (bit-equal to
    Pillow), ``/ 255`` and ``(v - 0.5) / 0.5``. Returns (size, size, 3)
    float32 in [-1, 1]."""
    out = _pil_resize(_to_u8(image01), size, PIL_BILINEAR).to(torch.float32) / 255.0
    return (out - 0.5) / 0.5


def preprocess_dinov2_processor_input(image01: torch.Tensor) -> torch.Tensor:
    """The reference offline dumper's preprocessing of an (H, W, 3) [0, 1]
    float32 image, as the JAX function computes it through PIL, in torch on
    the image's device. Stage 1, the dumper's torchvision transform:
    ``uint8`` by truncation, Pillow's bilinear resize to 224x224. Stage 2,
    the HF image processor on that [0, 1] tensor: ``uint8(floor(x * 255))``,
    Pillow's bicubic resize to 256x256, ``/ 255``, the centre crop
    ``[16:240]``, the processor's own ``* (1 / 255)`` again (the
    reference's double rescale: the backbone sees values in [0, 1/255]) and
    ImageNet normalisation. Returns (224, 224, 3) float32."""
    u8 = _pil_resize(_to_u8(image01), 224, PIL_BILINEAR)
    # Stage 2 starts from floor(float32(u8 / 255) * 255), which is u8 again:
    # in float32 that round trip is exact for all 256 values.
    x = _pil_resize(u8, 256, PIL_BICUBIC).to(torch.float32) / 255.0
    top = (256 - 224) // 2
    x = x[top:top + 224, top:top + 224] * (1.0 / 255.0)
    return normalize_image(x)


def load_torchvision_patch_embed(model: ViTPatchEmbed, state_dict: Mapping) -> ViTPatchEmbed:
    """A torchvision ``vit_b_16`` state dict's patch-embedding conv
    (``conv_proj.weight`` (768, 3, 16, 16), ``conv_proj.bias``) into
    ``model``, in place; a missing key or another shape leaves the init."""
    for name in ("weight", "bias"):
        value = state_dict.get(f"conv_proj.{name}")
        param = getattr(model.conv_proj, name)
        if value is not None and tuple(value.shape) == tuple(param.shape):
            with torch.no_grad():
                param.copy_(torch.as_tensor(np.asarray(value), dtype=param.dtype))
    return model


def find_torchvision_vit_b16_weights() -> Optional[str]:
    """A torchvision ``vit_b_16`` checkpoint already on disk, where the
    scripts' ``vit_b_16(weights=DEFAULT)`` would have cached it:
    ``$NERF_VIT_B16_WEIGHTS`` (a file), then the first
    ``$TORCH_HOME/hub/checkpoints/vit_b_16*.pth`` (``TORCH_HOME`` defaults
    to ``~/.cache/torch``). None when there is none; nothing is fetched."""
    p = os.environ.get("NERF_VIT_B16_WEIGHTS")
    if p and os.path.isfile(p):
        return p
    hub = os.path.join(os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch")),
                       "hub", "checkpoints")
    if os.path.isdir(hub):
        for name in sorted(os.listdir(hub)):
            if name.startswith("vit_b_16") and name.endswith(".pth"):
                return os.path.join(hub, name)
    return None


def find_dinov2_weights(model_name: str = "facebook/dinov2-base") -> Optional[str]:
    """A DINOv2 state dict already on disk, where the reference's
    ``AutoModel.from_pretrained(model_name)`` would have cached it:
    ``$NERF_DINOV2_WEIGHTS`` (a file), then the first
    ``pytorch_model.bin`` or ``model.safetensors`` of the sorted snapshot
    directories of ``$HF_HOME/hub/models--<org>--<name>`` (``HF_HOME``
    defaults to ``~/.cache/huggingface``). None when there is none; nothing
    is fetched."""
    p = os.environ.get("NERF_DINOV2_WEIGHTS")
    if p and os.path.isfile(p):
        return p
    hub = os.path.join(os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")),
                       "hub")
    snaps = os.path.join(hub, "models--" + model_name.replace("/", "--"), "snapshots")
    if os.path.isdir(snaps):
        for snap in sorted(os.listdir(snaps)):
            for fname in ("pytorch_model.bin", "model.safetensors"):
                cand = os.path.join(snaps, snap, fname)
                if os.path.isfile(cand):
                    return cand
    return None


# safetensors dtype -> numpy dtype (little-endian); BF16 is widened to float32
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays, without the ``safetensors``
    package: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (and an optional
    ``__metadata__``), then the raw little-endian data. BF16 tensors come
    back as float32 (numpy has no bfloat16; the widening is exact)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, which is not read")
        dtype = np.dtype(_SAFETENSORS_DTYPES[spec["dtype"]])
        begin, end = spec["data_offsets"]
        count = int(np.prod(spec["shape"], dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s data_offsets do not fit its shape or the file")
        arr = np.frombuffer(data, dtype, count, begin).reshape(spec["shape"])
        if spec["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict on disk as CPU tensors: ``.safetensors`` through
    ``read_safetensors``, anything else (``.bin``, ``.pth``) through
    ``torch.load(weights_only=True)``."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v) for k, v in read_safetensors(path).items()}
    return torch.load(path, map_location="cpu", weights_only=True)


def load_hf_dinov2_weights(model: DINOv2ViT, state_dict: Mapping) -> DINOv2ViT:
    """A HuggingFace ``Dinov2Model`` state dict (torch tensors or numpy
    arrays under HF's names) into ``model``, in place, key for key:
    ``embeddings.cls_token`` (1, 1, E) -> ``cls_token`` (1, E),
    ``position_embeddings[0]`` -> ``pos_embed``, the patch conv as it is
    (both are torch's (E, 3, p, p)), per layer ``norm1`` / ``norm2``,
    ``attention.attention.{query,key,value}`` (into the plain layer or the
    LoRA ``base``), ``attention.output.dense`` -> ``attention.out``,
    ``mlp.fc1`` / ``fc2``, ``layer_scale{1,2}.lambda1``, and ``layernorm``
    -> ``norm``. A tensor is put only where its shape matches (so a
    partial state dict loads); unknown keys are ignored, a missing key or
    another shape leaves the init, and ``lora_a`` / ``lora_b`` are never
    touched."""

    def put(param: torch.Tensor, key: str, take=lambda v: v) -> None:
        if key not in state_dict:
            return
        value = take(torch.as_tensor(state_dict[key]))
        if tuple(value.shape) == tuple(param.shape):
            with torch.no_grad():
                param.copy_(value.to(param.dtype))

    put(model.cls_token, "embeddings.cls_token", lambda v: v.reshape(1, -1))
    put(model.pos_embed, "embeddings.position_embeddings", lambda v: v[0])
    put(model.patch_embed.weight, "embeddings.patch_embeddings.projection.weight")
    put(model.patch_embed.bias, "embeddings.patch_embeddings.projection.bias")
    for i, block in enumerate(model.blocks):
        hf = f"encoder.layer.{i}"
        att = block.attention
        for layer, name in ((block.norm1, "norm1"), (block.norm2, "norm2"),
                            (att.query, "attention.attention.query"),
                            (att.key, "attention.attention.key"),
                            (att.value, "attention.attention.value"),
                            (att.out, "attention.output.dense"),
                            (block.mlp.fc1, "mlp.fc1"), (block.mlp.fc2, "mlp.fc2")):
            layer = layer.base if isinstance(layer, LoRADense) else layer
            put(layer.weight, f"{hf}.{name}.weight")
            put(layer.bias, f"{hf}.{name}.bias")
        if block.use_layerscale:
            put(block.layerscale1, f"{hf}.layer_scale1.lambda1")
            put(block.layerscale2, f"{hf}.layer_scale2.lambda1")
    put(model.norm.weight, "layernorm.weight")
    put(model.norm.bias, "layernorm.bias")
    return model


def _torch_key(path, leaf: np.ndarray):
    """One flax param path and leaf -> (torch state-dict key, tensor):
    ``block_i`` -> ``blocks.i``; a LayerNorm ``scale`` -> ``weight``; a
    Dense ``kernel`` (in, out) -> ``weight`` (out, in); the patch conv's
    kernel (p, p, 3, E) -> (E, 3, p, p); every other leaf as it is."""
    parts = [f"blocks.{p[len('block_'):]}" if p.startswith("block_") else p for p in path]
    name, value = parts[-1], np.asarray(leaf, np.float32)
    if name == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(parts[:-1] + [name]), torch.tensor(np.ascontiguousarray(value))


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree of numpy leaves (``DINOv2ViT``, an extractor around
    it, or ``ViTPatchEmbed``: ``conv_proj/kernel`` (16, 16, 3, 768) ->
    ``conv_proj.weight`` (768, 3, 16, 16)) -> the port module's state dict
    (``_torch_key`` per leaf)."""
    state: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
            else:
                key, value = _torch_key(path + [k], v)
                state[key] = value

    walk(params, [])
    return state


def vit_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``DINOv2ViT`` param tree -> ``DINOv2ViT``'s state dict."""
    return state_dict_from_jax(params)

