"""Raster plots without a plotting library (counterpart of
``nerf_fewshot_tpu/utils/plots.py``).

The analysis harness writes a feature-consistency heatmap, colormapped
depth maps and depth histograms. They are rasterized by hand in numpy: a
viridis / plasma colormap interpolated linearly between 9 anchors,
nearest-upscaled heatmap cells, and bar histograms on a white canvas. The
PNGs go through the port's own zlib writer (``utils/logging.py:save_png``):
the card machine has no Pillow. Pixels are ``uint8(clip(255 * x, 0, 255))``,
as the JAX package writes them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nerf_fewshot_tpu_torch.utils.logging import save_png

# Anchor-interpolated approximations of matplotlib's perceptual colormaps
# (the JAX package's 9 anchors, linear interpolation between them).
_VIRIDIS = np.array([
    [0.267, 0.005, 0.329],
    [0.283, 0.141, 0.458],
    [0.254, 0.265, 0.530],
    [0.207, 0.372, 0.553],
    [0.164, 0.471, 0.558],
    [0.128, 0.567, 0.551],
    [0.135, 0.659, 0.518],
    [0.478, 0.821, 0.318],
    [0.993, 0.906, 0.144],
], np.float32)

_PLASMA = np.array([
    [0.050, 0.030, 0.528],
    [0.294, 0.012, 0.631],
    [0.495, 0.012, 0.658],
    [0.665, 0.139, 0.586],
    [0.798, 0.280, 0.470],
    [0.899, 0.422, 0.361],
    [0.973, 0.586, 0.252],
    [0.993, 0.773, 0.155],
    [0.940, 0.975, 0.131],
], np.float32)

_MAPS = {"viridis": _VIRIDIS, "plasma": _PLASMA}


def apply_colormap(values: np.ndarray, cmap: str = "viridis",
                   vmin: Optional[float] = None,
                   vmax: Optional[float] = None) -> np.ndarray:
    """Map an array of scalars to (..., 3) float RGB in [0, 1]."""
    lut = _MAPS[cmap]
    v = np.asarray(values, np.float32)
    lo = float(np.min(v)) if vmin is None else vmin
    hi = float(np.max(v)) if vmax is None else vmax
    t = np.clip((v - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    x = t * (len(lut) - 1)
    i0 = np.clip(np.floor(x).astype(np.int32), 0, len(lut) - 2)
    frac = (x - i0)[..., None]
    return lut[i0] * (1 - frac) + lut[i0 + 1] * frac


def save_heatmap(path: str, matrix: np.ndarray, cell: int = 48,
                 cmap: str = "viridis", vmin: Optional[float] = None,
                 vmax: Optional[float] = None, grid: bool = True) -> None:
    """N x M matrix -> colormapped heatmap PNG with ``cell``-pixel cells and
    white grid lines."""
    rgb = apply_colormap(np.asarray(matrix, np.float32), cmap, vmin, vmax)
    img = np.repeat(np.repeat(rgb, cell, axis=0), cell, axis=1)
    if grid:
        img[::cell, :, :] = 1.0
        img[:, ::cell, :] = 1.0
    save_png(path, img)


def save_colormapped(path: str, image2d: np.ndarray, cmap: str = "plasma",
                     vmin: Optional[float] = None,
                     vmax: Optional[float] = None, scale: int = 2) -> None:
    """2D scalar field (a depth map) -> colormapped PNG, nearest-upscaled by
    ``scale``."""
    rgb = apply_colormap(image2d, cmap, vmin, vmax)
    if scale > 1:
        rgb = np.repeat(np.repeat(rgb, scale, axis=0), scale, axis=1)
    save_png(path, rgb)


def save_histogram(path: str, values: Sequence[float], bins: int = 50,
                   width: int = 400, height: int = 240,
                   color=(0.216, 0.494, 0.722)) -> None:
    """Bar histogram of ``values`` on a white canvas, with a black baseline."""
    v = np.asarray(values, np.float32).ravel()
    counts, _ = np.histogram(v, bins=bins)
    peak = max(int(counts.max()), 1)
    img = np.ones((height, width, 3), np.float32)
    bar_w = max(width // bins, 1)
    for b, c in enumerate(counts):
        h = int(round((height - 2) * (c / peak)))
        if h <= 0:
            continue
        x0 = b * bar_w
        img[height - h:, x0:x0 + bar_w] = color
    img[-1, :, :] = 0.0  # baseline axis
    save_png(path, img)
