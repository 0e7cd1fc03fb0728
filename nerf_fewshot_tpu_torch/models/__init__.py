"""NeRF models, the DINO feature extractors and their initialisation."""

from nerf_fewshot_tpu_torch.models.dino import (
    MultiScaleDINOFeatures,
    PatchEmbedFeatures,
    SpatialDINOFeatures,
    build_feature_extractor,
    dino_extractor_from_jax,
)
from nerf_fewshot_tpu_torch.models.fusion import NeRFDINOFusion
from nerf_fewshot_tpu_torch.models.lora import LoRADense, lora_label_fn, torch_dense
from nerf_fewshot_tpu_torch.models.mlp import (
    ColorMLP,
    DensityMLP,
    NeRFMLP,
    NeRFWithDINO,
    nerf_mlp_from_jax,
    nerf_with_dino_from_jax,
)
from nerf_fewshot_tpu_torch.models.vit import (
    DINOv2ViT,
    ViTConfig,
    ViTPatchEmbed,
    find_torchvision_vit_b16_weights,
    load_torchvision_patch_embed,
    preprocess_vit_b16_input,
    state_dict_from_jax,
    vit_from_jax,
)

__all__ = [
    "ColorMLP",
    "DINOv2ViT",
    "DensityMLP",
    "LoRADense",
    "MultiScaleDINOFeatures",
    "NeRFDINOFusion",
    "NeRFMLP",
    "NeRFWithDINO",
    "PatchEmbedFeatures",
    "SpatialDINOFeatures",
    "ViTConfig",
    "ViTPatchEmbed",
    "build_feature_extractor",
    "dino_extractor_from_jax",
    "find_torchvision_vit_b16_weights",
    "load_torchvision_patch_embed",
    "lora_label_fn",
    "nerf_mlp_from_jax",
    "nerf_with_dino_from_jax",
    "preprocess_vit_b16_input",
    "state_dict_from_jax",
    "torch_dense",
    "vit_from_jax",
]
