"""Stratified and hierarchical sampling along rays (counterpart of
``nerf_fewshot_tpu/ops/sampling.py``: ``sample_along_rays``,
``_searchsorted_right``, ``sample_pdf``, ``hierarchical_sample``).

Randomness is injected: the caller passes the jitter and importance
uniforms (drawn with its own ``torch.Generator``), so tests can feed both
frameworks the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    uniforms: Optional[torch.Tensor] = None,
    lindisp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_samples`` depths per ray, linear in depth (or inverse depth with
    ``lindisp``); ``uniforms`` of shape (..., n_samples) jitter each sample
    inside its mid-point bin, ``None`` keeps them deterministic.

    Returns ``pts`` (..., n_samples, 3) and ``z_vals`` (..., n_samples).
    """
    batch_shape = rays_o.shape[:-1]
    t = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype, device=rays_o.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z_vals = z.expand(batch_shape + (n_samples,))

    if uniforms is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * uniforms

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return pts, z_vals


def _searchsorted_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(..., right=True)``: for (..., B) non-decreasing
    ``cdf`` and (..., N) ``u``, the (..., N) number of cdf entries <= u."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)


def sample_pdf(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of ``n_importance`` new depths per ray
    from the (R, S) coarse ``weights`` at the (R, S) depths ``z_vals``
    (themselves the CDF's bin edges, as in the reference): a +1e-5 weight
    floor, a CDF with a leading zero, right-searchsorted uniforms, the
    bracket clamped to ``cdf[S]`` and ``z[S-1]`` where no entry exceeds u
    (the ``linspace`` endpoint 1.0), and linear interpolation with a < 1e-5
    denominator guard. ``uniforms`` (R, n_importance); ``None`` takes the
    evenly spaced ``linspace(0, 1)``. Returns (R, n_importance) unsorted
    depths."""
    R, S = z_vals.shape
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    if uniforms is None:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=z_vals.dtype, device=z_vals.device)
        u = u.expand(R, n_importance)
    else:
        u = uniforms
    idx = _searchsorted_right(cdf, u)  # in [1, S + 1]: cdf[0] = 0 <= u
    below = torch.clamp(idx - 1, min=0)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, torch.clamp(idx, max=S))
    bins_below = torch.gather(z_vals, -1, torch.clamp(below, max=S - 1))
    bins_above = torch.gather(z_vals, -1, torch.clamp(idx, max=S - 1))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_sample(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse + fine sampling: ``n_importance`` importance samples from the
    coarse ``weights`` (``sample_pdf``), merged with the coarse depths by a
    sort along the sample axis. Returns ``pts`` (R, S + n_importance, 3) and
    the sorted depths (R, S + n_importance)."""
    samples = sample_pdf(z_vals, weights, n_importance, uniforms)
    z_combined = torch.sort(torch.cat([z_vals, samples], dim=-1), dim=-1).values
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_combined[..., :, None]
    return pts, z_combined
