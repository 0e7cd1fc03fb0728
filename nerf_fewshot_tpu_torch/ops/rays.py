"""Pinhole ray generation and 3D->2D projection (counterpart of
``nerf_fewshot_tpu/ops/rays.py``).

OpenGL camera: looks down ``-z``, image ``y`` flipped, ``c2w`` 4x4
camera-to-world. The two projections reproduce the reference's own
conventions, quirks included (see each docstring).
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_rays(
    H: int, W: int, focal: float, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays through every pixel of an HxW image.

    Returns ``rays_o``, ``rays_d``: (H, W, 3), directions un-normalized.
    """
    dtype, device = c2w.dtype, c2w.device
    i = torch.arange(W, dtype=dtype, device=device)[None, :]
    j = torch.arange(H, dtype=dtype, device=device)[:, None]
    dirs = torch.stack(
        [
            ((i - W * 0.5) / focal).expand(H, W),
            (-(j - H * 0.5) / focal).expand(H, W),
            -torch.ones((H, W), dtype=dtype, device=device),
        ],
        dim=-1,
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as a fused multiply-add: the
    product of two fp32 values is exact in float64, so only the sum rounds
    there, then once more to fp32 (which differs from one rounding only for
    a value that lands on an fp32 tie, about one in 2^29)."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def phase_rays(
    H: int, W: int, focal: float, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training rays of a phase, as the JAX trainer's ``phase_data``
    makes them: its C++ host op (``nerf_fewshot_tpu/native``,
    ``nerf_get_rays``), whose shipped library fuses the first product and
    the sum of each direction component, ``fma(r_k0, dx, r_k1 * dy) -
    r_k2``, where ``get_rays`` (the jnp version's counterpart, the eval
    rays) takes a matrix product. The two round an ulp apart, which the
    samples' PE then amplifies.

    Returns ``rays_o``, ``rays_d``: (H, W, 3)."""
    dtype, device = c2w.dtype, c2w.device
    i = torch.arange(W, dtype=dtype, device=device)[None, :]
    j = torch.arange(H, dtype=dtype, device=device)[:, None]
    dx = ((i - W * 0.5) / focal).expand(H, W)
    dy = (-(j - H * 0.5) / focal).expand(H, W)
    r = c2w[:3, :3]
    rays_d = torch.stack([_fma(r[k, 0].expand(H, W), dx, r[k, 1] * dy) - r[k, 2]
                          for k in range(3)], dim=-1)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def project_points_to_image(
    points: torch.Tensor, c2w: torch.Tensor, focal: float, H: int, W: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points (N, 3) -> ``(points_2d (N, 2) in [-1, 1], depth (N,),
    valid (N,) bool)`` through the inverse of ``c2w``, with ``+z`` as the
    optical axis and no image-space y flip, ``valid = z > 0``: the
    reference projection, whose convention differs from ``get_rays`` (points
    in front of the camera get ``z < 0`` and ``valid`` False); reproduced,
    not fixed. The inverse is ``torch.linalg.inv_ex``, which does not
    synchronize with the device."""
    return project_points_w2c(points, torch.linalg.inv_ex(c2w)[0], focal, H, W)


def project_points_w2c(
    points: torch.Tensor, w2c: torch.Tensor, focal: float, H: int, W: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``project_points_to_image`` through a world-to-camera matrix taken
    once per view (``torch.linalg.inv_ex(c2w)[0]``), the same arithmetic."""
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    cam = homo @ w2c.T
    z = cam[..., 2]
    x = cam[..., 0] / (z + 1e-8) * focal + W / 2
    y = cam[..., 1] / (z + 1e-8) * focal + H / 2
    return torch.stack([(x / W) * 2.0 - 1.0, (y / H) * 2.0 - 1.0], dim=-1), z, z > 0


def project_points_script(
    points: torch.Tensor, c2w: torch.Tensor, focal: float, H: int, W: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standalone scripts' projection, another convention:
    ``cam = (p - t) @ R.T`` (the camera-to-world rotation applied forward,
    no inverse), ``+z`` optical axis, division by z with no epsilon, no
    validity mask. Returns ``(points_2d (N, 2), z (N,))``."""
    cam = (points - c2w[:3, 3]) @ c2w[:3, :3].T
    z = cam[..., 2]
    x = cam[..., 0] / z * focal + W / 2
    y = cam[..., 1] / z * focal + H / 2
    return torch.stack([(x / W) * 2.0 - 1.0, (y / H) * 2.0 - 1.0], dim=-1), z
