"""DINOv2-style ViT backbone with LoRA-injectable q/k/v, and the standalone
scripts' ViT-B/16 patch embedding (counterpart of
``nerf_fewshot_tpu/models/vit.py``: ``ViTConfig``, ``Attention``, ``MLP``,
``Block``, ``_interpolate_pos_embed``, ``DINOv2ViT``, ``normalize_image``,
``ViTPatchEmbed``, ``preprocess_vit_b16_input``,
``load_torchvision_patch_embed``, ``find_torchvision_vit_b16_weights``).

The layout is DINOv2's: a VALID patch-embedding conv (patch 14, stride 14),
a CLS token, the 37x37 position table of the 518-pixel pretraining grid
resized bilinearly to the image's patch grid, pre-LN blocks (exact GELU MLP,
LayerScale), a final LayerNorm; LayerNorm eps 1e-6. Attention and every
product are plain torch ops in the JAX order of operations.

The patch conv is computed as a product of the flattened patches with the
conv weight, exact fp32 on every device (cuDNN would take TF32 by
default); its weight keeps ``nn.Conv2d``'s (E, 3, p, p) layout. Pretrained
HuggingFace weights are not read (no weights are in the repository); the
backbone runs from its seeded random init, as the JAX package does without
weights. ``vit_from_jax`` carries a JAX param tree across.

``ViTPatchEmbed`` is torchvision ``vit_b_16``'s ``conv_proj`` alone (3 ->
768, kernel and stride 16), the scripts' feature source, on the input of
``preprocess_vit_b16_input``: the scripts' ``ToPILImage -> Resize((224,
224), bilinear) -> ToTensor -> Normalize(0.5, 0.5)``, without PIL (the card
machine has none): Pillow's fixed-point bilinear resample of uint8 pixels,
reproduced in integer torch operations bit for bit.
``find_torchvision_vit_b16_weights`` reads only a checkpoint already on
disk.
"""

from __future__ import annotations

import dataclasses
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


def _pil_bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's bilinear taps of one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): per output index its first input index and
    up to ``ksize`` fixed-point weights. Computed in Python doubles in
    Pillow's order of operations. Returns ``(index (out, ksize), weight
    (out, ksize))``, int64; taps past the window have weight 0 (their index
    clamped into the axis)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = 0.0
        for w in ws:
            total += w
        for x, w in enumerate(ws):
            w = w / total if total != 0.0 else w
            weight[i, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << PIL_PRECISION_BITS))
        index[i] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return index, weight


def _pil_resample(u8: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """One of Pillow's bilinear passes of an integer image along ``axis`` (1:
    the x axis, 0: y) to ``size``: ``clip((2^21 + sum w_j u_j) >> 22, 0,
    255)`` in int64."""
    index, weight = (torch.as_tensor(a, device=u8.device)
                     for a in _pil_bilinear_taps(u8.shape[axis], size))
    taps = torch.index_select(u8, axis, index.reshape(-1))
    if axis == 1:  # (H, out*k, 3) -> (H, out, k, 3)
        taps = taps.reshape(u8.shape[0], size, -1, 3)
        acc = torch.sum(taps * weight[None, :, :, None], dim=2)
    else:  # (out*k, W, 3) -> (out, k, W, 3)
        taps = taps.reshape(size, -1, u8.shape[1], 3)
        acc = torch.sum(taps * weight[:, :, None, None], dim=1)
    acc = (acc + (1 << (PIL_PRECISION_BITS - 1))) >> PIL_PRECISION_BITS
    return torch.clamp(acc, 0, 255)


def preprocess_vit_b16_input(image01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """The standalone scripts' transform of an (H, W, 3) [0, 1] float32
    image, as the JAX function computes it through PIL, in torch on the
    image's device: ``uint8(clip(x, 0, 1) * 255)`` (truncation, as
    ``ToPILImage``), Pillow's bilinear resize to (size, size) (the x axis
    first, then y; a pass only where that size changes; bit-equal to
    Pillow), ``/ 255`` and ``(v - 0.5) / 0.5``. Returns (size, size, 3)
    float32 in [-1, 1]."""
    u8 = (torch.clamp(image01, 0.0, 1.0) * 255.0).to(torch.uint8).to(torch.int64)
    if u8.shape[1] != size:
        u8 = _pil_resample(u8, size, axis=1)
    if u8.shape[0] != size:
        u8 = _pil_resample(u8, size, axis=0)
    out = u8.to(torch.float32) / 255.0
    return (out - 0.5) / 0.5


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

