"""Loss functions (counterpart of ``nerf_fewshot_tpu/training/losses.py``).

rgb MSE + optional depth L1 + optional weight-sparsity regularizer,
combined with config weights. Every term takes an optional per-ray
validity ``mask`` so padded ray batches give exact means over the real
rays, and an optional ``denom_rays``: the valid-ray count of the whole
batch when this call sees one rank's shard of it, so that the ranks'
losses sum to the batch's mean (data parallelism).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerf_fewshot_tpu_torch.training.config import LossConfig


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                 denom_rays: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    while mask.ndim < x.ndim:  # broadcast the mask over trailing dims
        mask = mask[..., None]
    rays = torch.sum(mask) if denom_rays is None else denom_rays
    denom = torch.clamp(rays, min=1.0) * (x.numel() / mask.numel())
    return torch.sum(x * mask) / denom


def nerf_loss(
    pred_rgb: torch.Tensor,
    target_rgb: torch.Tensor,
    cfg: LossConfig,
    pred_depth: Optional[torch.Tensor] = None,
    target_depth: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    denom_rays: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The loss dict ``{'rgb', ['depth'], ['regularization'], 'total'}``.
    Every masked mean divides by ``denom_rays`` (a 0-d tensor) instead of
    ``sum(mask)`` when it is given."""
    losses: Dict[str, torch.Tensor] = {}
    losses["rgb"] = _masked_mean((pred_rgb - target_rgb) ** 2, mask, denom_rays)
    total = cfg.rgb_weight * losses["rgb"]
    if target_depth is not None and pred_depth is not None and cfg.depth_weight > 0:
        losses["depth"] = _masked_mean(torch.abs(pred_depth - target_depth), mask, denom_rays)
        total = total + cfg.depth_weight * losses["depth"]
    if weights is not None and cfg.reg_weight > 0:
        losses["regularization"] = _masked_mean(weights**2, mask, denom_rays)
        total = total + cfg.reg_weight * losses["regularization"]
    losses["total"] = total
    return losses
