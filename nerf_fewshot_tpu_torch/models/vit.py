"""DINOv2-style ViT backbone with LoRA-injectable q/k/v (counterpart of
``nerf_fewshot_tpu/models/vit.py``: ``ViTConfig``, ``Attention``, ``MLP``,
``Block``, ``_interpolate_pos_embed``, ``DINOv2ViT``, ``normalize_image``).

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

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
        self.patch_embed = nn.utils.skip_init(nn.Conv2d, 3, E, p, stride=p)
        fan_in = 3 * p * p
        with torch.no_grad():
            self.patch_embed.weight.copy_(  # flax lecun_normal over (p, p, 3, E)
                trunc_normal((p, p, 3, E), math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                             generator).permute(3, 2, 0, 1))
            self.patch_embed.bias.zero_()
        self.cls_token = nn.Parameter(trunc_normal((1, E), 0.02, generator))
        base_side = cfg.base_image_size // p
        self.pos_embed = nn.Parameter(trunc_normal((1 + base_side * base_side, E), 0.02,
                                                   generator))
        self.blocks = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(E, eps=cfg.layernorm_eps)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        H, W, _ = image.shape
        p, E = self.cfg.patch_size, self.cfg.hidden_size
        Hp, Wp = H // p, W // p
        # VALID stride-p conv = the (Hp*Wp, p*p*3) patches, (kh, kw, c) order,
        # times the kernel in that order; the last H % p rows and columns drop
        patches = image[:Hp * p, :Wp * p].reshape(Hp, p, Wp, p, 3).permute(0, 2, 1, 3, 4)
        kernel = self.patch_embed.weight.permute(2, 3, 1, 0).reshape(p * p * 3, E)
        tokens = patches.reshape(Hp * Wp, p * p * 3) @ kernel + self.patch_embed.bias
        tokens = torch.cat([self.cls_token, tokens], dim=0)
        tokens = tokens + _interpolate_pos_embed(self.pos_embed, Hp)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an (H, W, 3) [0, 1] image."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
    std = torch.as_tensor(IMAGENET_STD, device=image.device)
    return (image - mean) / std


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
    """A flax param tree of numpy leaves (``DINOv2ViT`` or an extractor
    around it) -> the port module's state dict (``_torch_key`` per leaf)."""
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
