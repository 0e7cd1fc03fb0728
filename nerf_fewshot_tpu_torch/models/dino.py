"""Spatial and multi-scale DINO feature extractors and the standalone
scripts' patch embedding (counterpart of ``nerf_fewshot_tpu/models/dino.py``:
``TorchMHA``, ``SpatialDINOFeatures``, ``MultiScaleDINOFeatures``,
``LoRADINO``, ``_merge_pretrained_backbone``, ``build_feature_extractor``).

Each maps one (H, W, 3) image in [0, 1] to a feature grid. The first two
normalize it as ImageNet images inside:

* ``SpatialDINOFeatures``: the backbone's patch tokens (CLS dropped) plus a
  learnable spatial position embedding, projected 768+64 -> 256 -> 128 ->
  ``output_dim`` (64): (Hp, Wp, 64).
* ``MultiScaleDINOFeatures``: the backbone at input scales 1, 2 and 4
  under ``torch.no_grad`` (the reference's ``no_grad``, JAX's
  ``stop_gradient``: its LoRA trains nothing there), each scale projected
  768 -> 256 -> 128 and self-attended by one shared 8-head attention, the
  coarser grids resized bilinearly to the finest, concatenated and
  projected 384 -> 256 -> ``output_dim`` (128): (Hp, Wp, 128).
* ``PatchEmbedFeatures`` (``patch_embed``): the scripts' transform to a
  224x224 input (``preprocess_vit_b16_input``) and torchvision ViT-B/16's
  patch-embedding conv alone: (14, 14, 768).
* ``LoRADINOTokens`` (``dino_lora``, the offline token dumper of ``cli
  extract-features``): the processor preprocessing to 224x224 and
  ``LoRADINO``'s full (1 + 256, 768) token sequence.

The DINOv2 backbones take pretrained weights found on disk
(``_merge_pretrained_backbone``). The trainer runs an extractor once per
training view before training and conditions on the maps as constants.
``dino_extractor_from_jax`` carries a JAX extractor's param tree across.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device
from nerf_fewshot_tpu_torch.models.lora import torch_dense
from nerf_fewshot_tpu_torch.models.vit import (
    DINOv2ViT,
    ViTConfig,
    ViTPatchEmbed,
    find_dinov2_weights,
    find_torchvision_vit_b16_weights,
    load_hf_dinov2_weights,
    load_state_dict_file,
    load_torchvision_patch_embed,
    normalize_image,
    preprocess_dinov2_processor_input,
    preprocess_vit_b16_input,
    state_dict_from_jax,
)
from nerf_fewshot_tpu_torch.ops.interp import resize_bilinear


class TorchMHA(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)``-equivalent self-attention
    over (T, E) tokens, with separate q/k/v and out projections."""

    def __init__(self, embed_dim: int, num_heads: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.q = torch_dense(embed_dim, embed_dim, generator)
        self.k = torch_dense(embed_dim, embed_dim, generator)
        self.v = torch_dense(embed_dim, embed_dim, generator)
        self.out = torch_dense(embed_dim, embed_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, E = x.shape
        H = self.num_heads
        hd = E // H
        q = self.q(x).reshape(T, H, hd).transpose(0, 1)
        k = self.k(x).reshape(T, H, hd).transpose(0, 1)
        v = self.v(x).reshape(T, H, hd).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
        return self.out((att @ v).transpose(0, 1).reshape(T, E))


class SpatialDINOFeatures(nn.Module):
    """Single-scale extractor: image (H, W, 3) in [0, 1] -> (Hp, Wp, 64)."""

    def __init__(self, vit: ViTConfig = ViTConfig(), image_size: int = 128,
                 pos_embed_dim: int = 64, output_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vit_cfg = vit
        self.side = image_size // vit.patch_size
        self.backbone = DINOv2ViT(vit, generator)
        self.spatial_pos_embed = nn.Parameter(nn.init.normal_(
            torch.empty(self.side * self.side, pos_embed_dim), std=1.0, generator=generator))
        self.proj_0 = torch_dense(vit.hidden_size + pos_embed_dim, 256, generator)
        self.proj_1 = torch_dense(256, 128, generator)
        self.proj_2 = torch_dense(128, output_dim, generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        tokens = self.backbone(normalize_image(image))
        side = self.side
        grid = tokens[1:].reshape(side, side, self.vit_cfg.hidden_size)  # CLS dropped
        grid = torch.cat([grid, self.spatial_pos_embed.reshape(side, side, -1)], dim=-1)
        h = torch.relu(self.proj_0(grid))
        h = torch.relu(self.proj_1(h))
        return self.proj_2(h)


class MultiScaleDINOFeatures(nn.Module):
    """Multi-scale extractor: image (H, W, 3) in [0, 1] -> (Hp, Wp, 128)."""

    def __init__(self, vit: ViTConfig = ViTConfig(), scales: Sequence[int] = (1, 2, 4),
                 output_dim: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vit_cfg = vit
        self.scales = tuple(scales)
        self.backbone = DINOv2ViT(vit, generator)
        self.cross_scale_attention = TorchMHA(128, 8, generator)
        for s in self.scales:
            self.add_module(f"scale_{s}_proj0", torch_dense(vit.hidden_size, 256, generator))
            self.add_module(f"scale_{s}_proj1", torch_dense(256, 128, generator))
        self.final_proj0 = torch_dense(128 * len(self.scales), 256, generator)
        self.final_proj1 = torch_dense(256, output_dim, generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = normalize_image(image)
        H, W, _ = x.shape
        p, E = self.vit_cfg.patch_size, self.vit_cfg.hidden_size
        per_scale = []
        for s in self.scales:
            xs = x if s == 1 else resize_bilinear(x, H // s, W // s)
            with torch.no_grad():
                tokens = self.backbone(xs)
            side = xs.shape[0] // p
            proj = torch.relu(getattr(self, f"scale_{s}_proj0")(tokens[1:].reshape(side, side, E)))
            proj = getattr(self, f"scale_{s}_proj1")(proj)
            per_scale.append(
                self.cross_scale_attention(proj.reshape(side * side, 128)).reshape(side, side, 128))
        target = per_scale[0].shape[0]
        aligned = [per_scale[0]] + [resize_bilinear(f, target, target) for f in per_scale[1:]]
        h = torch.relu(self.final_proj0(torch.cat(aligned, dim=-1)))
        return self.final_proj1(h)


class PatchEmbedFeatures(ViTPatchEmbed):
    """The standalone scripts' extractor (``patch_embed``): an (H, W, 3)
    [0, 1] image through ``preprocess_vit_b16_input`` (uint8, Pillow's
    bilinear resize to 224x224, mean/std 0.5) and the ViT-B/16
    patch-embedding conv: (14, 14, 768). Its state dict is
    ``ViTPatchEmbed``'s."""

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return super().forward(preprocess_vit_b16_input(image))


class LoRADINO(nn.Module):
    """The reference's minimal LoRA-DINO (``dino_lora.LoRADINO``): a
    ``DINOv2ViT`` with LoRA on q/k/v (default rank 4, alpha 16) over the
    processor output (``preprocess_dinov2_processor_input``), returning
    the full token sequence, CLS first: (1 + 256, hidden) at 224x224."""

    def __init__(self, vit: ViTConfig = ViTConfig(lora_rank=4),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = DINOv2ViT(vit, generator)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.backbone(pixel_values)


class LoRADINOTokens(LoRADINO):
    """The offline token dumper (``dino_lora``): an (H, W, 3) [0, 1] image
    through ``preprocess_dinov2_processor_input`` and ``LoRADINO``: the
    (1 + 256, hidden) tokens, CLS first (the dump site drops it). Its state
    dict is ``LoRADINO``'s."""

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return super().forward(preprocess_dinov2_processor_input(image))


def _merge_pretrained_backbone(model: nn.Module, model_name: str) -> bool:
    """The DINOv2 weight chain: ``find_dinov2_weights`` (``$NERF_DINOV2_WEIGHTS``,
    then the HF hub cache) and ``load_hf_dinov2_weights`` into
    ``model.backbone``, in place. False (the seeded random init stays) when
    nothing is on disk."""
    path = find_dinov2_weights(model_name)
    if path is None:
        return False
    load_hf_dinov2_weights(model.backbone, load_state_dict_file(path))
    print(f"[dino] loaded pretrained backbone weights from {path}")
    return True


def build_feature_extractor(dino_cfg, image_size: int, vit: Optional[ViTConfig] = None,
                            seed: int = 0, device: DeviceLike = None) -> nn.Module:
    """The configured extractor in eval mode on ``device`` (default
    ``cuda``), its parameters drawn from ``torch.Generator().manual_seed(seed)``
    with the JAX package's init distributions. ``model(image01 (H, W, 3))``
    gives the feature grid (``single_scale``, ``multi_scale``, and
    ``patch_embed``: the standalone scripts' ViT-B/16 conv, whose weights are
    read from a torchvision checkpoint already on disk when
    ``find_torchvision_vit_b16_weights`` finds one), or for ``dino_lora``
    (the offline token dumper, ``LoRADINOTokens``: LoRA rank
    ``dino_cfg.lora_rank``, or 4) the (1 + 256, hidden) token sequence. The
    DINOv2 backbones take the weights of ``dino_cfg.name`` where
    ``find_dinov2_weights`` finds them on disk."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    if dino_cfg.model_type == "patch_embed":
        model = PatchEmbedFeatures(generator=generator)
        path = find_torchvision_vit_b16_weights()
        if path is not None:
            load_torchvision_patch_embed(model, load_state_dict_file(path))
            print(f"[dino] loaded vit_b_16 patch-embed weights from {path}")
        return model.to(dev).eval()
    if dino_cfg.model_type == "dino_lora":
        rank = dino_cfg.lora_rank if dino_cfg.lora_rank > 0 else 4
        model = LoRADINOTokens(ViTConfig(lora_rank=rank, lora_alpha=dino_cfg.lora_alpha),
                               generator=generator)
    else:
        if vit is None:
            vit = ViTConfig(lora_rank=dino_cfg.lora_rank if dino_cfg.use_lora else 0,
                            lora_alpha=dino_cfg.lora_alpha)
        if dino_cfg.model_type == "multi_scale":
            model = MultiScaleDINOFeatures(vit=vit, generator=generator)
        else:
            model = SpatialDINOFeatures(vit=vit, image_size=image_size, generator=generator)
    _merge_pretrained_backbone(model, dino_cfg.name)
    return model.to(dev).eval()


def dino_extractor_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``SpatialDINOFeatures`` / ``MultiScaleDINOFeatures`` / ``LoRADINO`` param tree
    (numpy leaves) -> the port extractor's state dict: Dense kernels
    transposed, LayerNorm ``scale`` -> ``weight``, the patch conv kernel to
    (E, 3, p, p); ``lora_a``/``lora_b``, the layerscales, ``cls_token``,
    ``pos_embed``, ``spatial_pos_embed`` and ``TorchMHA``'s q/k/v/out as they
    are."""
    return state_dict_from_jax(params)
