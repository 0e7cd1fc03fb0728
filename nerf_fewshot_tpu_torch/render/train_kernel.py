"""The single-pass training objective: forward, masked loss and every packed
weight's gradient in one kernel call (counterpart of
``nerf_fewshot_tpu/render/train_kernel.py``: ``_train_pe_kernel`` and
``_train_kernel`` around ``_objective_body``, entry ``fused_train_loss_grad``).

``fused_train_objective`` launches the CUDA kernel of ``csrc/train_pe.cu``
on CUDA tensors (``inline_pe=True``: the inline-PE kernel; ``False``: the
same source built for a pre-encoded ``x``) and runs
``fused_train_objective_reference``, the plain PyTorch version, on CPU
tensors. There is no other route.

Gradients reach the ``NeRFMLP`` parameters through the differentiable
``pack_params``: ``_TrainObjective`` returns the kernel's packed gradients,
scaled by the incoming cotangent, as its backward, which is what the JAX
package's ``jax.vjp`` over ``pack_params`` does.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays
from nerf_fewshot_tpu_torch.render.fused import encode_points
from nerf_fewshot_tpu_torch.render.kernels import (
    KERNEL_WIDTHS,
    MAX_LAYERS,
    D_PAD,
    MAX_INPUT_WIDTH,
    MAX_SAMPLES,
    OUT_PAD,
    PE_ALIGN,
    Packed,
    _check_card,
    _check_compute_dtype,
    _composite,
    _expect,
    _lib_fn,
    _pe_input,
    _raise_on,
    _raw_block,
    _scratch,
    _split_grads,
    _trunk,
    fused_render_fwd,
    fused_render_fwd_pe,
    pack_params,
    pe_layout,
    pe_width,
)
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

# csrc/train_pe.cu:nerf_train_objective(19 pointers, 10 ints, 3 floats, int, stream)
TRAIN_ARGTYPES = (
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
    + [ctypes.c_int, ctypes.c_void_p]
)
CALLER = "fused_train_objective"


def _objective_loss(x, z, dnorm, tgt, mask, inv_denom, packed: Packed, white_bkgd,
                    rgb_weight, reg_weight, depth_weight, tgt_depth) -> torch.Tensor:
    """``_objective_body``'s forward and loss, from the (N, D) input ``x``:
    the trunk and packed head, sigmoid rgb, log-space compositing (1e10 far
    delta, 1e-10 epsilon), the masked squared error scaled by
    ``rgb_weight * inv_denom``, the w^2 term at ``3*r/S * inv_denom`` and
    the depth term at ``3*d * inv_denom``."""
    R, S = z.shape
    out, _ = _trunk(x, packed)
    rgb_s = torch.sigmoid(out[:, 0:3]).reshape(R, S, 3)
    weights = _composite(out[:, 3].reshape(R, S), z, dnorm)
    rgb_map = torch.sum(weights[..., None] * rgb_s, dim=1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=1, keepdim=True))
    err = (rgb_map - tgt) * mask
    loss = torch.sum(err * err) * (rgb_weight * inv_denom)
    if reg_weight:
        wsq = torch.sum(weights * weights, dim=1, keepdim=True)
        loss = loss + torch.sum(wsq * mask) * ((3.0 * reg_weight / S) * inv_denom)
    if tgt_depth is not None:
        diff = torch.sum(weights * z, dim=1, keepdim=True) - tgt_depth
        loss = loss + torch.sum(torch.abs(diff) * mask) * (3.0 * depth_weight * inv_denom)
    return loss.reshape(())


def fused_train_objective_reference(
    raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed: Packed, *,
    white_bkgd: bool = False, inline_pe: bool = True, rgb_weight: float = 1.0,
    reg_weight: float = 0.0, depth_weight: float = 0.0,
    tgt_depth: Optional[torch.Tensor] = None, compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, Packed]:
    """Plain PyTorch version of the kernel, on any device: the kernel's
    forward arithmetic (exact PE phases, ``sin(phase + pi/2)`` for cos,
    ``cumsum`` for the transmittance), its gradients from
    ``torch.autograd.grad`` over the packed tensors. Matmuls must run in
    fp32 (``torch.backends.cuda.matmul.allow_tf32`` False, the default).
    Returns ``(loss (), dpacked)``."""
    _check_compute_dtype(compute_dtype)
    with torch.enable_grad():
        leaves = tuple(p.detach().requires_grad_(True) for p in packed)
        if inline_pe:
            x = _pe_input(raw_or_x, feats, e2, c, leaves[0].shape[0])
        else:
            x = raw_or_x
        loss = _objective_loss(x, z, dnorm, tgt, mask, inv_denom, leaves, white_bkgd,
                               rgb_weight, reg_weight, depth_weight, tgt_depth)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    dpacked = tuple(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), dpacked


def fused_train_objective(
    raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed: Packed, *,
    white_bkgd: bool = False, inline_pe: bool = True, rgb_weight: float = 1.0,
    reg_weight: float = 0.0, depth_weight: float = 0.0,
    tgt_depth: Optional[torch.Tensor] = None, compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, Packed]:
    """``(loss (), dpacked)`` of the training objective over R rays x S samples.

    ``raw_or_x``: the thin (R*S, n_raw) ``[pts | dirs?]`` block with
    ``inline_pe`` (``e2``/``c`` from ``pe_layout``, ``feats`` (R*S, Fd) or
    ``None``), else the pre-encoded (R*S, D) ``x`` (``feats``, ``e2``, ``c``
    unused). ``z`` (R, S), ``dnorm``/``mask`` (R, 1), ``tgt`` (R, 3),
    ``inv_denom`` (1,) = 1/(3*denominator rays), ``tgt_depth`` (R, 1) or
    ``None`` (no depth term). CPU tensors run the plain version; CUDA
    tensors launch the kernel and count one in
    ``fused_train_objective.launches["train_pe" or "train_x"]``.
    """
    _check_compute_dtype(compute_dtype)
    kw = dict(white_bkgd=white_bkgd, inline_pe=inline_pe, rgb_weight=rgb_weight,
              reg_weight=reg_weight, depth_weight=depth_weight, tgt_depth=tgt_depth,
              compute_dtype=compute_dtype)
    if raw_or_x.device.type == "cpu":
        return fused_train_objective_reference(
            raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed, **kw)
    device = raw_or_x.device
    _check_card(device, CALLER)
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    D, H = w0.shape
    L1 = wh.shape[0]
    if H not in KERNEL_WIDTHS:
        raise ValueError(f"{CALLER}: trunk width {H} not in {KERNEL_WIDTHS}")
    if not (1 <= S <= MAX_SAMPLES) or R < 1:
        raise ValueError(f"{CALLER}: need R >= 1 and 1 <= S <= {MAX_SAMPLES}; got {R}, {S}")
    if L1 + 1 > MAX_LAYERS:
        raise ValueError(f"{CALLER}: at most {MAX_LAYERS} trunk layers; got {L1 + 1}")
    if inline_pe:
        n_raw, n_phase = raw_or_x.shape[1], e2.shape[1]
        Fd = 0 if feats is None else feats.shape[1]
        if D % PE_ALIGN or D > MAX_INPUT_WIDTH or n_raw + n_phase + Fd > D:
            raise ValueError(
                f"{CALLER}: input width {n_raw}+{n_phase}+{Fd} needs d_pad >= it, "
                f"a multiple of {PE_ALIGN} and <= {MAX_INPUT_WIDTH}; got {D}")
        _expect(raw_or_x, "raw", (R * S, n_raw), device, CALLER)
        if feats is not None:
            _expect(feats, "feats", (R * S, Fd), device, CALLER)
        _expect(e2, "e2", (n_raw, n_phase), device, CALLER)
        _expect(c, "c", (1, n_phase), device, CALLER)
    else:
        n_raw = n_phase = Fd = 0
        if D % D_PAD or D > MAX_INPUT_WIDTH:
            raise ValueError(f"{CALLER}: x width {D} must be a multiple of {D_PAD} "
                             f"and <= {MAX_INPUT_WIDTH}")
        _expect(raw_or_x, "x", (R * S, D), device, CALLER)
    _expect(z, "z", (R, S), device, CALLER)
    _expect(dnorm, "dnorm", (R, 1), device, CALLER)
    _expect(tgt, "tgt", (R, 3), device, CALLER)
    _expect(mask, "mask", (R, 1), device, CALLER)
    _expect(inv_denom, "inv_denom", (1,), device, CALLER)
    if tgt_depth is not None:
        _expect(tgt_depth, "tgt_depth", (R, 1), device, CALLER)
    _expect(w0, "w0", (D, H), device, CALLER)
    _expect(b0, "b0", (1, H), device, CALLER)
    _expect(wh, "wh", (L1, H, H), device, CALLER)
    _expect(bh, "bh", (L1, H), device, CALLER)
    _expect(wout, "wout", (H, OUT_PAD), device, CALLER)
    _expect(bout, "bout", (1, OUT_PAD), device, CALLER)

    lib, fn = _lib_fn("train_pe", "nerf_train_objective", TRAIN_ARGTYPES)
    scratch = _scratch(lib, device, R, S, D, H, L1)
    loss = torch.empty(1, dtype=torch.float32, device=device)
    grads = torch.empty(sum(p.numel() for p in packed), dtype=torch.float32, device=device)
    opt = lambda t: None if t is None else t.data_ptr()
    ptrs = [raw_or_x.data_ptr(), opt(feats if inline_pe else None), z.data_ptr(),
            dnorm.data_ptr(), tgt.data_ptr(), mask.data_ptr(), inv_denom.data_ptr(),
            opt(tgt_depth), opt(e2 if inline_pe else None), opt(c if inline_pe else None),
            *(p.data_ptr() for p in packed), loss.data_ptr(), grads.data_ptr(),
            scratch.data_ptr()]
    err = fn(*ptrs, R, S, n_raw, n_phase, Fd, D, H, L1, int(inline_pe), int(white_bkgd),
             float(rgb_weight), float(3.0 * reg_weight / S), float(3.0 * depth_weight),
             device.index, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, lib, "train_pe")
    fused_train_objective.launches["train_pe" if inline_pe else "train_x"] += 1
    return loss.reshape(()), _split_grads(grads, packed)


fused_train_objective.launches = {"train_pe": 0, "train_x": 0}


class _TrainObjective(torch.autograd.Function):
    """The objective as a differentiable function of the six packed
    tensors: forward runs ``fused_train_objective`` and keeps its packed
    gradients; backward returns them times the incoming cotangent."""

    @staticmethod
    def forward(ctx, raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, opts, *packed):
        loss, dpacked = fused_train_objective(
            raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c,
            tuple(p.detach() for p in packed), **opts)
        ctx.save_for_backward(*dpacked)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        return (None,) * 10 + tuple(grad_out * d for d in ctx.saved_tensors)


@torch.no_grad()
def _coarse_weights(params, pts, rays_d, z, dnorm, settings, pos_freq, dir_freq, num_layers,
                    hidden_dim, use_viewdirs, compute_dtype, inline_pe, point_features_fn,
                    lora_alpha):
    """The hierarchical coarse pass: the compositing weights (R, S) of the
    stratified samples, through kernel 2 (``inline_pe``) or kernel 4, with no
    gradient (the sampling distribution is stop-gradient)."""
    feats = None
    if point_features_fn is not None:
        feats = point_features_fn(pts.reshape(-1, 3)).contiguous()
    if inline_pe:
        perm, e2, c, x_dim = pe_layout(pos_freq, dir_freq, use_viewdirs,
                                       0 if feats is None else feats.shape[1])
        packed = pack_params(params, num_layers, hidden_dim,
                             d_pad=pe_width(x_dim), row_perm=perm, lora_alpha=lora_alpha)
        out = fused_render_fwd_pe(
            _raw_block(pts, rays_d, use_viewdirs), feats, z.contiguous(), dnorm,
            torch.as_tensor(e2, device=z.device), torch.as_tensor(c, device=z.device), packed,
            settings.white_bkgd, compute_dtype, use_feats=feats is not None)
    else:
        x = encode_points(pts, rays_d, pos_freq, dir_freq, use_viewdirs, feats).contiguous()
        packed = pack_params(params, num_layers, hidden_dim, d_pad=x.shape[-1],
                             lora_alpha=lora_alpha)
        out = fused_render_fwd(x, z.contiguous(), dnorm, packed, settings.white_bkgd,
                               compute_dtype)
    return out[3]


def train_objective_inputs(
    params: Mapping[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    settings: RenderSettings,
    pos_freq: int,
    dir_freq: int,
    num_layers: int,
    hidden_dim: int,
    use_viewdirs: bool = True,
    compute_dtype: str = "float32",
    uniforms: Optional[torch.Tensor] = None,
    denom_rays: Optional[Union[float, torch.Tensor]] = None,
    inline_pe: bool = True,
    reg_weight: float = 0.0,
    depth_weight: float = 0.0,
    target_depth: Optional[torch.Tensor] = None,
    point_features_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rgb_weight: float = 1.0,
    importance_uniforms: Optional[torch.Tensor] = None,
    lora_alpha: float = 16.0,
):
    """The host glue of ``fused_train_loss_grad``: sampling (with
    ``settings.n_importance``, the coarse pass and the importance samples),
    the kernel's input block and ``pack_params`` of ``params``
    (differentiable when they require grad). Returns ``(args, opts)`` for
    ``fused_train_objective(*args, **opts)``."""
    if settings.noise_std != 0.0:
        raise ValueError("fused_train_loss_grad: sigma noise is not supported by the kernel")
    tgt_depth = None
    if depth_weight > 0.0 and target_depth is not None:
        tgt_depth = target_depth.reshape(-1, 1).contiguous()
    else:
        depth_weight = 0.0
    pts, z = sample_along_rays(
        rays_o, rays_d, settings.near, settings.far, settings.n_samples,
        uniforms=uniforms if settings.perturb else None, lindisp=settings.lindisp,
    )
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if settings.n_importance > 0:
        weights_c = _coarse_weights(params, pts, rays_d, z, dnorm, settings, pos_freq, dir_freq,
                                    num_layers, hidden_dim, use_viewdirs, compute_dtype,
                                    inline_pe, point_features_fn, lora_alpha)
        pts, z = hierarchical_sample(
            rays_o, rays_d, z, weights_c, settings.n_importance,
            uniforms=importance_uniforms if settings.perturb else None)
    feats = None
    if point_features_fn is not None:
        feats = point_features_fn(pts.reshape(-1, 3)).contiguous()
    denom = torch.sum(mask) if denom_rays is None else torch.as_tensor(
        denom_rays, dtype=rays_o.dtype, device=rays_o.device)
    inv_denom = (1.0 / (3.0 * torch.clamp(denom, min=1.0))).reshape(1)
    if inline_pe:
        feat_dim = 0 if feats is None else feats.shape[1]
        perm, e2, c, x_dim = pe_layout(pos_freq, dir_freq, use_viewdirs, feat_dim)
        packed = pack_params(params, num_layers, hidden_dim,
                             d_pad=pe_width(x_dim), row_perm=perm, lora_alpha=lora_alpha)
        inp = _raw_block(pts, rays_d, use_viewdirs)
        e2 = torch.as_tensor(e2, device=rays_o.device)
        c = torch.as_tensor(c, device=rays_o.device)
    else:
        inp = encode_points(pts, rays_d, pos_freq, dir_freq, use_viewdirs, feats).contiguous()
        packed = pack_params(params, num_layers, hidden_dim, d_pad=inp.shape[-1],
                             lora_alpha=lora_alpha)
        e2 = c = feats = None
    args = (inp, feats, z.contiguous(), dnorm, target.contiguous(),
            mask.reshape(-1, 1).to(rays_o.dtype).contiguous(), inv_denom, e2, c, packed)
    opts = dict(white_bkgd=settings.white_bkgd, inline_pe=inline_pe, rgb_weight=rgb_weight,
                reg_weight=reg_weight, depth_weight=depth_weight, tgt_depth=tgt_depth,
                compute_dtype=compute_dtype)
    return args, opts


def fused_train_loss_grad(
    model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,  # (R,) validity
    settings: RenderSettings,
    pos_freq: int,
    dir_freq: int,
    num_layers: int,
    hidden_dim: int,
    use_viewdirs: bool = True,
    compute_dtype: str = "float32",
    uniforms: Optional[torch.Tensor] = None,
    denom_rays: Optional[Union[float, torch.Tensor]] = None,
    inline_pe: bool = True,
    reg_weight: float = 0.0,
    depth_weight: float = 0.0,
    target_depth: Optional[torch.Tensor] = None,
    point_features_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rgb_weight: float = 1.0,
    importance_uniforms: Optional[torch.Tensor] = None,
    lora_alpha: float = 16.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(masked-MSE loss, parameter gradients by name) in one kernel call.

    ``model_or_state``: a ``NeRFMLP`` (its parameters) or a state dict.
    ``uniforms`` (R, n_samples) jitter the stratified samples when
    ``settings.perturb``; without them the samples are the bin edges, as the
    JAX function does without a key. ``denom_rays`` overrides the
    normalizer (default: the local sum of ``mask``); ``rgb_weight`` scales
    the rgb term (``loss.rgb_weight``); ``depth_weight`` counts only with
    ``target_depth``. ``point_features_fn(pts (N, 3)) -> (N, Fd)`` appends
    per-point features to the MLP input. With ``settings.n_importance`` a
    forward-only coarse pass (kernel 2 with ``inline_pe``, else kernel 4)
    gives the weights the importance samples are drawn from, with the
    (R, n_importance) ``importance_uniforms`` when ``settings.perturb`` (the
    evenly spaced ``linspace(0, 1)`` without them); the objective then runs
    over the merged, sorted ``n_samples + n_importance`` depths. LoRA trunk
    layers are merged with ``lora_alpha`` (``pack_params``), and their
    gradients come back under ``lora_a`` / ``lora_b``.
    """
    if isinstance(model_or_state, nn.Module):
        params = dict(model_or_state.named_parameters())
    else:
        params = {k: v.detach().requires_grad_(True) for k, v in model_or_state.items()}
    args, opts = train_objective_inputs(
        params, rays_o, rays_d, target, mask, settings, pos_freq, dir_freq, num_layers,
        hidden_dim, use_viewdirs, compute_dtype, uniforms, denom_rays, inline_pe,
        reg_weight, depth_weight, target_depth, point_features_fn, rgb_weight,
        importance_uniforms, lora_alpha)
    *inputs, packed = args
    loss = _TrainObjective.apply(*inputs, opts, *packed)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    return loss.detach(), dict(zip(names, grads))
