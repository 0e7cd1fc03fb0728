"""NeRF models, the DINO feature extractors and their initialisation."""

from nerf_fewshot_tpu_torch.models.dino import (
    MultiScaleDINOFeatures,
    SpatialDINOFeatures,
    build_feature_extractor,
    dino_extractor_from_jax,
)
from nerf_fewshot_tpu_torch.models.lora import LoRADense, torch_dense
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.models.vit import DINOv2ViT, ViTConfig, vit_from_jax

__all__ = [
    "DINOv2ViT",
    "LoRADense",
    "MultiScaleDINOFeatures",
    "NeRFMLP",
    "SpatialDINOFeatures",
    "ViTConfig",
    "build_feature_extractor",
    "dino_extractor_from_jax",
    "nerf_mlp_from_jax",
    "torch_dense",
    "vit_from_jax",
]
