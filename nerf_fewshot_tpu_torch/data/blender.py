"""Blender-synthetic (NeRF paper format) datasets (counterpart of
``nerf_fewshot_tpu/data/blender.py``), numpy on the host.

PIL is imported inside ``load_blender`` only, so the rest of the port runs
where PIL is absent; ``save_blender`` writes its PNGs with the port's own
zlib writer (``utils/logging.py:save_png``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from nerf_fewshot_tpu_torch.utils.logging import save_png


@dataclasses.dataclass
class BlenderDataset:
    """One split: images (N, H, W, 3 or 4) float32 in [0, 1], poses
    (N, 4, 4) float32 camera-to-world, and intrinsics."""

    images: np.ndarray
    poses: np.ndarray
    H: int
    W: int
    focal: float

    @property
    def n_views(self) -> int:
        return self.images.shape[0]

    def white_composited(self) -> np.ndarray:
        """RGBA -> RGB over white; RGB passes through unchanged."""
        if self.images.shape[-1] == 3:
            return self.images
        rgba = np.asarray(self.images, np.float32)
        a = rgba[..., 3:4]
        return rgba[..., :3] * a + (1.0 - a)

    def few_shot(self, num_views: int) -> "BlenderDataset":
        """The first ``num_views`` views (the reference's first-k slice)."""
        return dataclasses.replace(
            self, images=self.images[:num_views], poses=self.poses[:num_views]
        )


def load_blender(
    basedir: str,
    split: str = "train",
    img_size: Optional[int] = None,
    half_res: bool = False,
    keep_alpha: bool = True,
    focal_convention: str = "reference",
) -> BlenderDataset:
    """Load one split of a Blender-synthetic scene directory.

    ``focal_convention='reference'`` applies the resize scale to a focal
    already computed from the resized width (the reference's double
    scaling, load-bearing for its published numbers); ``'physical'`` is the
    true pinhole focal of the resized image.
    """
    from PIL import Image

    with open(os.path.join(basedir, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    images, poses = [], []
    for frame in meta["frames"]:
        img_path = os.path.join(basedir, frame["file_path"] + ".png")
        if not os.path.exists(img_path):
            raise FileNotFoundError(f"Image not found: {img_path}")
        img = Image.open(img_path)
        img = img.convert("RGBA" if keep_alpha and "A" in img.getbands() else "RGB")
        W_orig, _ = img.size
        if img_size:
            resize = (img_size, img_size)
            focal_scale = img_size / W_orig
        elif half_res:
            resize = (img.size[0] // 2, img.size[1] // 2)
            focal_scale = 0.5
        else:
            resize = None
            focal_scale = 1.0
        if resize is not None and resize != img.size:
            img = img.resize(resize, Image.LANCZOS)
        images.append(np.asarray(img, dtype=np.float32) / 255.0)
        poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))

    images_np = np.stack(images)
    H, W = images_np.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
    if focal_convention == "reference":
        focal *= focal_scale
    return BlenderDataset(
        images=images_np, poses=np.stack(poses), H=H, W=W, focal=float(focal)
    )


def save_blender(
    basedir: str,
    split: str,
    images: np.ndarray,
    poses: np.ndarray,
    camera_angle_x: float,
) -> None:
    """Write a split in Blender-synthetic layout: ``<split>/r_<i>.png`` (RGB
    or RGBA, pixels ``uint8(clip(255 * x, 0, 255))``) and
    ``transforms_<split>.json`` with the poses and ``camera_angle_x``, as
    the JAX package's ``save_blender`` writes it (a round trip for tests)."""
    os.makedirs(os.path.join(basedir, split), exist_ok=True)
    frames = []
    for i, (img, pose) in enumerate(zip(images, poses)):
        rel = f"./{split}/r_{i}"
        save_png(os.path.join(basedir, f"{rel}.png"), np.asarray(img))
        frames.append({"file_path": rel, "transform_matrix": np.asarray(pose).tolist()})
    with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
