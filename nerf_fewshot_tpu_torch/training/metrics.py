"""PSNR, SSIM and LPIPS (counterpart of
``nerf_fewshot_tpu/training/metrics.py``).

SSIM uses torchmetrics' defaults: 11x11 gaussian window, sigma 1.5,
k1 0.01, k2 0.03. The window is applied as an explicit separable sum in
fp32, so no convolution runs in TF32 on a GPU. ``LPIPSMetric`` is the
third metric of the reference's triple (LPIPS(VGG), inputs scaled to
[-1, 1]).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device
from nerf_fewshot_tpu_torch.training.lpips import LPIPS


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: Optional[float] = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio; ``data_range=None`` takes max-min over
    the union of pred and target."""
    if data_range is None:
        data_range = torch.maximum(pred.max(), target.max()) - torch.minimum(
            pred.min(), target.min()
        )
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_1d(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(size, dtype=like.dtype, device=like.device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter2d(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Valid-mode correlation of (H, W, C) with the window ``outer(g, g)``,
    as a separable sum over rows, then columns."""
    k = g.shape[0]
    Ho, Wo = img.shape[0] - k + 1, img.shape[1] - k + 1
    rows = sum(g[i] * img[i:i + Ho] for i in range(k))
    return sum(g[j] * rows[:, j:j + Wo] for j in range(k))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair."""
    if min(pred.shape[0], pred.shape[1]) < kernel_size:
        raise ValueError(f"ssim: image {tuple(pred.shape)} is smaller than the {kernel_size}-wide window")
    g = _gaussian_1d(kernel_size, sigma, pred)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = _filter2d(pred, g)
    mu_t = _filter2d(target, g)
    mu_pp = _filter2d(pred * pred, g)
    mu_tt = _filter2d(target * target, g)
    mu_pt = _filter2d(pred * target, g)
    # E[x^2] - E[x]^2 can dip below 0 in fp32 on flat windows
    var_p = torch.clamp(mu_pp - mu_p ** 2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t ** 2, min=0.0)
    cov = mu_pt - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


class LPIPSMetric:
    """LPIPS(VGG) on [0, 1] images, (H, W, 3) arrays or tensors.

    Takes the ``lpips`` package's ``LPIPS(net='vgg')`` when it imports
    (the published pretrained numbers), as the JAX class does; otherwise
    the port's ``training/lpips.py``: pretrained when VGG16 weights are on
    disk, else the seeded-random VGG with uniform heads, whose values live
    on another scale than the published pretrained-VGG ones.
    ``pretrained`` and ``backend`` (``torch-lpips``,
    ``torch-pretrained-vgg`` or ``torch-random-vgg``) say which ran."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lpips_package_model = None
        try:
            import lpips as lpips_package

            self._lpips_package_model = lpips_package.LPIPS(net="vgg").to(self.device)
            self.pretrained = True
            self.backend = "torch-lpips"
        except ImportError:
            self._model = LPIPS(device=self.device)
            self.pretrained = self._model.pretrained
            self.backend = "torch-pretrained-vgg" if self.pretrained else "torch-random-vgg"

    @torch.no_grad()
    def __call__(self, pred, target) -> float:
        if self._lpips_package_model is None:
            return self._model(pred, target)
        p, t = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                .permute(2, 0, 1)[None] * 2 - 1 for x in (pred, target))
        return float(self._lpips_package_model(p, t).item())
