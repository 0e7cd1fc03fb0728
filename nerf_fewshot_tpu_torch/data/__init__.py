"""Datasets: Blender-synthetic splits and procedural synthetic scenes."""

from nerf_fewshot_tpu_torch.data.blender import BlenderDataset, load_blender, save_blender
from nerf_fewshot_tpu_torch.data.synthetic import (
    lego_like_scene,
    make_scene_dataset,
    orbit_pose,
)

__all__ = [
    "BlenderDataset",
    "lego_like_scene",
    "load_blender",
    "make_scene_dataset",
    "orbit_pose",
    "save_blender",
]
