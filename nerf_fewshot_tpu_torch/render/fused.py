"""Fused rendering: sampling and host glue around the inline-PE kernel
(counterpart of ``nerf_fewshot_tpu/render/fused.py``: ``_pad_lanes``,
``encode_points`` and ``fused_render_rays`` with ``forward_only=True``; the
differentiable path needs kernels 3 and 4).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device
from nerf_fewshot_tpu_torch.ops.composite import RenderOutputs
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding
from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
from nerf_fewshot_tpu_torch.render.kernels import (
    D_PAD,
    _raw_block,
    fused_render_fwd_pe,
    pack_params,
    pe_layout,
)
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings


def _pad_lanes(x: torch.Tensor, multiple: int = D_PAD) -> torch.Tensor:
    """Zero-pad the last dim up to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def encode_points(
    pts: torch.Tensor,  # (R, S, 3)
    rays_d: torch.Tensor,  # (R, 3)
    pos_freq: int,
    dir_freq: int,
    use_viewdirs: bool,
    feats: Optional[torch.Tensor] = None,  # (R*S, Fd) per-point features
) -> torch.Tensor:
    """The pre-encoded (R*S, D) input of the train kernel's ``inline_pe=False``
    mode: ``[PE(pos) | PE(dir) | feats]`` in NeRFMLP's input order (cos
    computed directly), zero-padded to a multiple of 128 columns."""
    R, S, _ = pts.shape
    parts = [positional_encoding(pts.reshape(-1, 3), pos_freq)]
    if use_viewdirs:
        dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
        parts.append(positional_encoding(dirs, dir_freq))
    if feats is not None:
        parts.append(feats)
    return _pad_lanes(torch.cat(parts, dim=-1))


@torch.no_grad()
def fused_render_rays(
    params: Mapping[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    pos_freq: int,
    dir_freq: int,
    num_layers: int,
    hidden_dim: int,
    use_viewdirs: bool = True,
    compute_dtype: str = "float32",
    forward_only: bool = False,
    device: DeviceLike = None,
) -> RenderOutputs:
    """Render (R, 3) rays of a NeRFMLP (``params``: its state dict) through
    the inline-PE forward kernel on ``device`` (default ``cuda``; the CPU
    runs the kernel's plain version). Deterministic sampling only: the
    eval and serving render."""
    if not forward_only:
        raise NotImplementedError(
            "fused_render_rays(forward_only=False) needs the backward kernels, "
            "which are not ported yet"
        )
    if settings.noise_std != 0.0:
        raise ValueError("fused backend: sigma noise is not supported")
    if settings.perturb:
        raise NotImplementedError("fused backend: perturbed sampling is not ported yet")
    if settings.n_importance > 0:
        raise NotImplementedError("fused backend: hierarchical sampling is not ported yet")
    dev = resolve_device(device)
    rays_o = rays_o.to(dev)
    rays_d = rays_d.to(dev)
    state = {k: v.to(dev) for k, v in params.items()}

    perm, e2, c, x_dim = pe_layout(pos_freq, dir_freq, use_viewdirs, 0)
    packed = pack_params(
        state, num_layers, hidden_dim, d_pad=-(-x_dim // D_PAD) * D_PAD, row_perm=perm
    )
    pts, z = sample_along_rays(
        rays_o, rays_d, settings.near, settings.far, settings.n_samples,
        lindisp=settings.lindisp,
    )
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rgb, depth, acc, weights = fused_render_fwd_pe(
        _raw_block(pts, rays_d, use_viewdirs), None, z.contiguous(), dnorm,
        torch.as_tensor(e2, device=dev), torch.as_tensor(c, device=dev), packed,
        white_bkgd=settings.white_bkgd, compute_dtype=compute_dtype,
    )
    return RenderOutputs(rgb=rgb, depth=depth[:, 0], acc=acc[:, 0], weights=weights)
