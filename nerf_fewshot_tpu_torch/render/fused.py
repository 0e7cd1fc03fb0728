"""Fused rendering: sampling, hierarchical coarse + fine passes and host
glue around the render kernels (counterpart of
``nerf_fewshot_tpu/render/fused.py``: ``_pad_lanes``, ``encode_points`` and
``fused_render_rays``): the forward-only inline-PE kernel (kernel 2) for
eval, the differentiable ``fused_render`` (kernels 4 and 3) otherwise.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device
from nerf_fewshot_tpu_torch.ops.composite import RenderOutputs
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding
from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays
from nerf_fewshot_tpu_torch.render.kernels import (
    D_PAD,
    Packed,
    _raw_block,
    fused_render,
    fused_render_fwd_pe,
    pack_params,
    pe_constants,
    pe_width,
)
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings


def _pad_lanes(x: torch.Tensor, multiple: int = D_PAD) -> torch.Tensor:
    """Zero-pad the last dim up to a multiple of ``multiple``."""
    pad = (-x.shape[-1]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def encoded_width(pos_freq: int, dir_freq: int, use_viewdirs: bool, feat_dim: int = 0) -> int:
    """The width of ``encode_points``' output: its live columns padded to a
    multiple of ``D_PAD``."""
    live = 3 * (2 * pos_freq + 1) + (3 * (2 * dir_freq + 1) if use_viewdirs else 0) + feat_dim
    return -(-live // D_PAD) * D_PAD


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
    uniforms: Optional[torch.Tensor] = None,
    importance_uniforms: Optional[torch.Tensor] = None,
    point_features_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    lora_alpha: float = 16.0,
    packed: Optional[Packed] = None,
) -> RenderOutputs:
    """Render (R, 3) rays of a NeRFMLP (``params``: its state dict, or its
    named parameters to differentiate) through the render kernels on
    ``device`` (default ``cuda``; the CPU runs the kernels' plain versions).

    ``forward_only``: the inline-PE forward kernel under no-grad, for eval
    and serving; the result is not differentiable. Otherwise the points are
    encoded (``encode_points``) and rendered by the differentiable
    ``fused_render``: gradients reach ``params`` and, through the encoded
    input, ``point_features_fn``'s output (none reach ``z`` or
    ``||rays_d||``, as in the JAX rule). With ``settings.perturb`` the
    (R, n_samples) ``uniforms`` jitter the stratified samples and the
    (R, n_importance) ``importance_uniforms`` draw the hierarchical ones
    (deterministic without them). ``settings.n_importance > 0`` runs a
    coarse and a fine pass with the same weights, the importance samples
    drawn from the coarse weights under stop-gradient.
    ``point_features_fn(pts (N, 3)) -> (N, Fd)`` appends per-point features
    to the MLP input. LoRA trunk layers are merged with ``lora_alpha``
    (``pack_params``). ``packed``: with ``forward_only``, the
    ``pack_params(row_perm=pe_constants(...).row_perm)`` weights of
    ``params`` packed once by the caller for many calls (an eval call's
    chunks), used instead of packing ``params`` in every pass."""
    if settings.noise_std != 0.0:
        raise ValueError("fused backend: sigma noise is not supported")
    if packed is not None and not forward_only:
        raise ValueError("fused_render_rays: packed weights are for forward_only calls")
    dev = resolve_device(device)
    rays_o = rays_o.to(dev)
    rays_d = rays_d.to(dev)
    state = {k: v.to(dev) for k, v in params.items()}
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    def run(pts: torch.Tensor, z: torch.Tensor) -> RenderOutputs:
        feats = None
        if point_features_fn is not None:
            feats = point_features_fn(pts.reshape(-1, 3))
        if forward_only:
            consts = pe_constants(pos_freq, dir_freq, use_viewdirs,
                                  0 if feats is None else feats.shape[1], dev)
            pw = packed if packed is not None else pack_params(
                state, num_layers, hidden_dim, d_pad=pe_width(consts.x_dim),
                row_perm=consts.row_perm, lora_alpha=lora_alpha)
            rgb, depth, acc, weights = fused_render_fwd_pe(
                _raw_block(pts, rays_d, use_viewdirs),
                None if feats is None else feats.contiguous(), z.contiguous(), dnorm,
                consts.e2, consts.c, pw, white_bkgd=settings.white_bkgd,
                compute_dtype=compute_dtype, use_feats=feats is not None,
            )
        else:
            x = encode_points(pts, rays_d, pos_freq, dir_freq, use_viewdirs, feats).contiguous()
            pw = pack_params(state, num_layers, hidden_dim, d_pad=x.shape[-1],
                             lora_alpha=lora_alpha)
            rgb, depth, acc, weights = fused_render(
                x, z, dnorm, pw, white_bkgd=settings.white_bkgd, compute_dtype=compute_dtype)
        return RenderOutputs(rgb=rgb, depth=depth[:, 0], acc=acc[:, 0], weights=weights)

    with torch.set_grad_enabled(torch.is_grad_enabled() and not forward_only):
        pts, z = sample_along_rays(
            rays_o, rays_d, settings.near, settings.far, settings.n_samples,
            uniforms=uniforms if settings.perturb else None, lindisp=settings.lindisp,
        )
        out = run(pts, z)
        if settings.n_importance > 0:
            pts, z = hierarchical_sample(
                rays_o, rays_d, z, out.weights.detach(), settings.n_importance,
                uniforms=importance_uniforms if settings.perturb else None,
            )
            out = run(pts, z)
    return out
