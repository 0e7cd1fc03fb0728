"""Bilinear interpolation with torch's coordinate conventions (counterpart
of ``nerf_fewshot_tpu/ops/interp.py``), written out with the JAX
package's arithmetic: its tap weights, its zero padding, its source
coordinates.

* ``grid_sample``: ``F.grid_sample(mode='bilinear', padding_mode='zeros')``
  of an (H, W, C) map at normalized (x, y) points, ``align_corners``
  either way (the config-driven trainer uses False, the standalone
  scripts True).
* ``resize_bilinear``: ``F.interpolate(mode='bilinear')`` of an (H, W, C)
  image, no antialiasing, edge-clamped taps.

Both are differentiable gathers; nothing here calls ``F.grid_sample`` or
``F.interpolate``.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] normalized coordinates -> pixel coordinates (torch convention)."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample(features: torch.Tensor, points: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Sample an (H, W, C) feature map at (..., 2) normalized points
    ordered (x, y) (x indexes W, y indexes H). Bilinear; a tap outside the
    map contributes 0. Returns (..., C)."""
    H, W, C = features.shape
    x = _unnormalize(points[..., 0], W, align_corners)
    y = _unnormalize(points[..., 1], H, align_corners)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = features.reshape(H * W, C)

    def tap(xi, yi):
        in_bounds = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        ix = torch.clamp(xi, 0, W - 1).long()
        iy = torch.clamp(yi, 0, H - 1).long()
        vals = flat[(iy * W + ix).reshape(-1)].reshape(*xi.shape, C)
        return torch.where(in_bounds[..., None], vals, vals.new_zeros(()))

    return (tap(x0, y0) * (wx0 * wy0)[..., None] + tap(x1, y0) * (wx1 * wy0)[..., None]
            + tap(x0, y1) * (wx0 * wy1)[..., None] + tap(x1, y1) * (wx1 * wy1)[..., None])


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Resize an (H, W, C) image to (out_h, out_w, C). With
    ``align_corners=False`` the source coordinate is
    ``max((dst + 0.5) * in/out - 0.5, 0)``; with True, ``dst * (in-1)/(out-1)``."""
    H, W, _ = image.shape

    def src_coords(out_size: int, in_size: int) -> torch.Tensor:
        d = torch.arange(out_size, dtype=image.dtype, device=image.device)
        if align_corners:
            if out_size == 1:
                return torch.zeros_like(d)
            return d * (in_size - 1) / (out_size - 1)
        return torch.clamp((d + 0.5) * (in_size / out_size) - 0.5, min=0.0)

    ys, xs = src_coords(out_h, H), src_coords(out_w, W)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy1 = (ys - y0.to(image.dtype))[:, None, None]
    wx1 = (xs - x0.to(image.dtype))[None, :, None]
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    top = image[y0][:, x0] * wx0 + image[y0][:, x1] * wx1
    bot = image[y1][:, x0] * wx0 + image[y1][:, x1] * wx1
    return top * wy0 + bot * wy1
