"""The single-pass training objective: forward, masked loss and every packed
weight's gradient in one kernel call (counterpart of
``nerf_fewshot_tpu/render/train_kernel.py``: ``_train_pe_kernel`` and
``_train_kernel`` around ``_objective_body``, entry ``fused_train_loss_grad``).

``fused_train_objective`` launches the CUDA kernel of ``csrc/train_pe.cu``
on CUDA tensors (``inline_pe=True``: the inline-PE kernel; ``False``: the
same source built for a pre-encoded ``x``) and runs
``fused_train_objective_reference``, the plain PyTorch version, on CPU
tensors. There is no other route.

``fused_train_loss_grad`` maps the kernel's packed gradients back to the
``NeRFMLP`` parameters, which is what the JAX package's ``jax.vjp`` over
``pack_params`` does, without the autograd engine: ``packed_grads`` for a
trunk without LoRA, ``lora_pack_vjp`` (``csrc/lora_pack.cu`` on a card) for
a LoRA trunk.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays
from nerf_fewshot_tpu_torch.render.fused import encode_points, encoded_width
from nerf_fewshot_tpu_torch.render.lora_pack import is_lora_trunk, lora_pack_vjp
from nerf_fewshot_tpu_torch.render.kernels import (
    D_PAD,
    OUT_PAD,
    PE_ALIGN,
    Packed,
    _check_card,
    _check_points,
    _check_width,
    _composite,
    _composite_terms,
    _expect,
    _lib_fn,
    _pe_input,
    _raise_on,
    _raw_block,
    _render_vjp,
    _scratch,
    _split_grads,
    _src_names,
    _trunk,
    fused_render_fwd,
    fused_render_fwd_pe,
    pack_params,
    packed_grads,
    pe_constants,
    pe_width,
    route_of,
)
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

# csrc/train_pe.cu:nerf_train_objective(19 pointers, 10 ints, 3 floats, 4 ints, stream)
TRAIN_ARGTYPES = (
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
)
CALLER = "fused_train_objective"
HEAD_MODES = ("mxu", "vpu")


def _pin_dtypes(compute_dtype: str, dw_precision: Optional[str], head_mode: str):
    """The JAX entry's two per-product pins as the routes of the six dW
    products and of the head: ``dw_precision="highest"`` runs the dW
    products in exact fp32 (``_dot_dw``); ``head_mode="vpu"`` the head's
    three products (forward, the chain's seed, its dW) in exact fp32,
    whatever ``compute_dtype`` is. Returns ``(dw_dtype, head_dtype)``, each
    ``None`` where it follows ``compute_dtype``."""
    route_of(compute_dtype)
    if dw_precision not in (None, "highest"):
        raise ValueError(f"dw_precision must be None or 'highest'; got {dw_precision!r}")
    if head_mode not in HEAD_MODES:
        raise ValueError(f"head_mode must be one of {HEAD_MODES}; got {head_mode!r}")
    return dw_precision, ("highest" if head_mode == "vpu" else None)


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


def _objective_analytic(x, z, dnorm, tgt, mask, inv_denom, packed: Packed, white_bkgd,
                        rgb_weight, reg_weight, depth_weight, tgt_depth, compute_dtype,
                        dw_dtype, head_dtype) -> Tuple[torch.Tensor, Packed]:
    """``_objective_body`` written out as the kernel computes it: the
    forward and loss of ``_objective_loss``, then the render's analytic VJP
    (``_render_vjp``) seeded by the loss's cotangents of rgb (``2*err*
    rgb_weight*inv_denom``), depth (the depth term's sign) and the weights
    (the w^2 term's ``2*reg_scale*mask*w``). Every product rounds its two
    operands where the JAX body does (``_dot``), the cotangent operand of
    each chain and dW product included, which autograd through a bf16 cast
    would round after the product instead."""
    R, S = z.shape
    out, acts = _trunk(x, packed, compute_dtype, head_dtype)
    weights = _composite_terms(out[:, 3].reshape(R, S), z, dnorm)[-1]
    rgb_s = torch.sigmoid(out[:, 0:3]).reshape(R, S, 3)
    rgb_map = torch.sum(weights[..., None] * rgb_s, dim=1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=1, keepdim=True))
    err = (rgb_map - tgt) * mask
    scale = rgb_weight * inv_denom
    loss = torch.sum(err * err) * scale
    g_rgb = 2.0 * err * scale
    g_depth = torch.zeros_like(mask)
    g_weights = torch.zeros_like(weights)
    if reg_weight:
        reg_scale = (3.0 * reg_weight / S) * inv_denom
        wsq = torch.sum(weights * weights, dim=1, keepdim=True)
        loss = loss + torch.sum(wsq * mask) * reg_scale
        g_weights = (2.0 * reg_scale) * mask * weights
    if tgt_depth is not None:
        d_scale = 3.0 * depth_weight * inv_denom
        diff = torch.sum(weights * z, dim=1, keepdim=True) - tgt_depth
        loss = loss + torch.sum(torch.abs(diff) * mask) * d_scale
        g_depth = d_scale * torch.sign(diff) * mask
    _, grads = _render_vjp(out, acts, z, dnorm, packed, g_rgb, g_depth, torch.zeros_like(mask),
                           g_weights, white_bkgd, compute_dtype, False, dw_dtype, head_dtype)
    return loss.reshape(()), grads


def fused_train_objective_reference(
    raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed: Packed, *,
    white_bkgd: bool = False, inline_pe: bool = True, rgb_weight: float = 1.0,
    reg_weight: float = 0.0, depth_weight: float = 0.0,
    tgt_depth: Optional[torch.Tensor] = None, compute_dtype: str = "float32",
    dw_precision: Optional[str] = None, head_mode: str = "mxu",
) -> Tuple[torch.Tensor, Packed]:
    """Plain PyTorch version of the kernel, on any device: the kernel's
    forward arithmetic (exact PE phases, ``sin(phase + pi/2)`` for cos,
    ``cumsum`` for the transmittance). ``bfloat16``, whose products round
    their operands, takes its gradients from the analytic backward of
    ``_objective_analytic``; ``float32`` and ``highest`` (pinned or not:
    every plain product is exact fp32 there, matmuls without TF32, PyTorch's
    default) from ``torch.autograd.grad`` over the packed tensors. Returns
    ``(loss (), dpacked)``."""
    dw_dtype, head_dtype = _pin_dtypes(compute_dtype, dw_precision, head_mode)
    if compute_dtype == "bfloat16":
        x = _pe_input(raw_or_x, feats, e2, c, packed[0].shape[0]) if inline_pe else raw_or_x
        return _objective_analytic(x, z, dnorm, tgt, mask, inv_denom, packed, white_bkgd,
                                   rgb_weight, reg_weight, depth_weight, tgt_depth,
                                   compute_dtype, dw_dtype, head_dtype)
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
    dw_precision: Optional[str] = None, head_mode: str = "mxu",
) -> Tuple[torch.Tensor, Packed]:
    """``(loss (), dpacked)`` of the training objective over R rays x S samples.

    ``raw_or_x``: the thin (R*S, n_raw) ``[pts | dirs?]`` block with
    ``inline_pe`` (``e2``/``c`` from ``pe_constants``, ``feats`` (R*S, Fd) or
    ``None``), else the pre-encoded (R*S, D) ``x`` (``feats``, ``e2``, ``c``
    unused). ``z`` (R, S), ``dnorm``/``mask`` (R, 1), ``tgt`` (R, 3),
    ``inv_denom`` (1,) = 1/(3*denominator rays), ``tgt_depth`` (R, 1) or
    ``None`` (no depth term). CPU tensors run the plain version; CUDA
    tensors launch the kernel and count one in
    ``fused_train_objective.launches["train_pe" or "train_x"]``.
    ``compute_dtype`` picks the precision route of the products (``ROUTES``
    in ``render/kernels.py``); ``dw_precision="highest"`` runs the six dW
    products and ``head_mode="vpu"`` the head's products in exact fp32
    whatever the route (the JAX entry's pins).
    """
    route = route_of(compute_dtype)
    dw_dtype, head_dtype = _pin_dtypes(compute_dtype, dw_precision, head_mode)
    kw = dict(white_bkgd=white_bkgd, inline_pe=inline_pe, rgb_weight=rgb_weight,
              reg_weight=reg_weight, depth_weight=depth_weight, tgt_depth=tgt_depth,
              compute_dtype=compute_dtype, dw_precision=dw_precision, head_mode=head_mode)
    if raw_or_x.device.type == "cpu":
        return fused_train_objective_reference(
            raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed, **kw)
    device = raw_or_x.device
    _check_card(device, CALLER)
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    D, H = w0.shape
    L1 = wh.shape[0]
    _check_width(H, CALLER)
    _check_points(R, S, CALLER)
    if inline_pe:
        n_raw, n_phase = raw_or_x.shape[1], e2.shape[1]
        Fd = 0 if feats is None else feats.shape[1]
        if D % PE_ALIGN or n_raw + n_phase + Fd > D:
            raise ValueError(
                f"{CALLER}: input width {n_raw}+{n_phase}+{Fd} needs d_pad >= it and "
                f"a multiple of {PE_ALIGN}; got {D}")
        _expect(raw_or_x, "raw", (R * S, n_raw), device, CALLER)
        if feats is not None:
            _expect(feats, "feats", (R * S, Fd), device, CALLER)
        _expect(e2, "e2", (n_raw, n_phase), device, CALLER)
        _expect(c, "c", (1, n_phase), device, CALLER)
    else:
        n_raw = n_phase = Fd = 0
        if D % D_PAD:
            raise ValueError(f"{CALLER}: x width {D} must be a multiple of {D_PAD}")
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
             route, route_of(dw_dtype or compute_dtype), int(head_dtype is not None),
             device.index, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, lib, "train_pe")
    fused_train_objective.launches["train_pe" if inline_pe else "train_x"] += 1
    return loss.reshape(()), _split_grads(grads, packed)


fused_train_objective.launches = {"train_pe": 0, "train_x": 0}


@torch.no_grad()
def _coarse_weights(packed: Packed, consts, pts, rays_d, z, dnorm, settings, use_viewdirs,
                    compute_dtype, inline_pe, pos_freq, dir_freq, feats):
    """The hierarchical coarse pass: the compositing weights (R, S) of the
    stratified samples, through kernel 2 (``inline_pe``: ``consts`` from
    ``pe_constants``) or kernel 4, with the step's packed weights
    (detached) and no gradient (the sampling distribution is
    stop-gradient)."""
    packed = tuple(p.detach() for p in packed)
    if inline_pe:
        out = fused_render_fwd_pe(
            _raw_block(pts, rays_d, use_viewdirs), feats, z.contiguous(), dnorm, consts.e2,
            consts.c, packed, settings.white_bkgd, compute_dtype, use_feats=feats is not None)
    else:
        x = encode_points(pts, rays_d, pos_freq, dir_freq, use_viewdirs, feats).contiguous()
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
    dw_precision: Optional[str] = None,
    head_mode: str = "mxu",
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
    feats = None
    if point_features_fn is not None:
        feats = point_features_fn(pts.reshape(-1, 3)).contiguous()
    feat_dim = 0 if feats is None else feats.shape[1]
    consts = None
    if inline_pe:
        consts = pe_constants(pos_freq, dir_freq, use_viewdirs, feat_dim, rays_o.device)
        d_pad, row_perm = pe_width(consts.x_dim), consts.row_perm
    else:
        d_pad, row_perm = encoded_width(pos_freq, dir_freq, use_viewdirs, feat_dim), None
    packed = pack_params(params, num_layers, hidden_dim, d_pad=d_pad, row_perm=row_perm,
                         lora_alpha=lora_alpha)
    if settings.n_importance > 0:
        weights_c = _coarse_weights(packed, consts, pts, rays_d, z, dnorm, settings,
                                    use_viewdirs, compute_dtype, inline_pe, pos_freq, dir_freq,
                                    feats)
        pts, z = hierarchical_sample(
            rays_o, rays_d, z, weights_c, settings.n_importance,
            uniforms=importance_uniforms if settings.perturb else None)
        if point_features_fn is not None:
            feats = point_features_fn(pts.reshape(-1, 3)).contiguous()
    if denom_rays is None:
        denom = torch.sum(mask)
    elif isinstance(denom_rays, torch.Tensor):
        denom = denom_rays.to(dtype=rays_o.dtype, device=rays_o.device)
    else:  # a fill on the device, not a copy from the host
        denom = torch.full((), float(denom_rays), dtype=rays_o.dtype, device=rays_o.device)
    inv_denom = (1.0 / (3.0 * torch.clamp(denom, min=1.0))).reshape(1)
    if inline_pe:
        inp = _raw_block(pts, rays_d, use_viewdirs)
        e2, c = consts.e2, consts.c
    else:
        inp = encode_points(pts, rays_d, pos_freq, dir_freq, use_viewdirs, feats).contiguous()
        e2 = c = feats = None
    args = (inp, feats, z.contiguous(), dnorm, target.contiguous(),
            mask.reshape(-1, 1).to(rays_o.dtype).contiguous(), inv_denom, e2, c, packed)
    opts = dict(white_bkgd=settings.white_bkgd, inline_pe=inline_pe, rgb_weight=rgb_weight,
                reg_weight=reg_weight, depth_weight=depth_weight, tgt_depth=tgt_depth,
                compute_dtype=compute_dtype, dw_precision=dw_precision, head_mode=head_mode)
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
    dw_precision: Optional[str] = None,
    head_mode: str = "mxu",
    grad_buffer: Optional[torch.Tensor] = None,
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
    gradients come back under ``lora_a`` / ``lora_b``. ``compute_dtype``
    picks the kernels' precision route (``float32``, ``bfloat16``,
    ``highest``); ``dw_precision="highest"`` and ``head_mode="vpu"`` pin the
    dW products and the head to exact fp32, as the JAX entry's pins do.
    The gradients come from the kernel's packed ones without the autograd
    engine (``_pack_vjp``): what autograd through ``pack_params`` gives back
    for the loss's cotangent of one.
    ``grad_buffer``: a flat float32 buffer the size of every parameter
    together; the gradients are also written there, each contiguous in its
    parameter's shape, in ``_src_names`` order for a trunk without LoRA (one
    gather from the packed gradients, ``packed_grads(out=)``) and in
    ``params`` order for a LoRA trunk (``lora_pack_vjp(out=)``: the VJP
    kernel writes them there on a card; its plain version's copied there on
    the CPU). The returned gradients are the plain version's as they come,
    the layouts a reduction over them sums in (on a card a LoRA trunk's are
    the buffer's views).
    """
    if isinstance(model_or_state, nn.Module):
        params = dict(model_or_state.named_parameters())
    else:
        params = dict(model_or_state)
    with torch.no_grad():
        args, opts = train_objective_inputs(
            params, rays_o, rays_d, target, mask, settings, pos_freq, dir_freq, num_layers,
            hidden_dim, use_viewdirs, compute_dtype, uniforms, denom_rays, inline_pe,
            reg_weight, depth_weight, target_depth, point_features_fn, rgb_weight,
            importance_uniforms, lora_alpha, dw_precision, head_mode)
        *inputs, packed = args
        loss, dpacked = fused_train_objective(*inputs, packed, **opts)
        row_perm = None
        if inline_pe:
            feats = inputs[1]
            row_perm = pe_constants(pos_freq, dir_freq, use_viewdirs,
                                    0 if feats is None else feats.shape[1],
                                    rays_o.device).row_perm
        grads = _pack_vjp(params, num_layers, hidden_dim, row_perm, lora_alpha, dpacked,
                          grad_buffer)
    return loss.detach(), grads


def _pack_vjp(params: Mapping[str, torch.Tensor], num_layers: int, hidden_dim: int,
              row_perm, lora_alpha: float, dpacked: Packed,
              grad_buffer: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters' gradients, by name, from the gradients ``dpacked`` of
    ``pack_params(params, ..., row_perm)``: ``packed_grads`` for a trunk
    without LoRA, ``lora_pack_vjp`` for a LoRA trunk (its kernel on a card,
    its plain version on the CPU); each also written into ``grad_buffer``
    when given."""
    if is_lora_trunk(params, num_layers):
        cpu = dpacked[0].device.type == "cpu"
        return lora_pack_vjp(params, dpacked, num_layers, hidden_dim, row_perm, lora_alpha,
                             out=grad_buffer, plain=cpu)
    d_pad = dpacked[0].shape[0]
    grads = packed_grads(params, num_layers, hidden_dim, d_pad, row_perm, dpacked)
    if grad_buffer is not None:
        packed_grads(params, num_layers, hidden_dim, d_pad, row_perm, dpacked, out=grad_buffer)
    return grads


def grad_buffer(params: Mapping[str, torch.Tensor], num_layers: int, extra: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A zeroed flat buffer for ``fused_train_loss_grad(grad_buffer=)`` over
    ``params`` (a model's parameters by name) and its views by name, each
    contiguous in its parameter's shape, laid out as the call writes them;
    ``extra`` more elements after the gradients (a mesh step's loss: one
    all-reduce sums both, ``parallel/fused_dp.py``)."""
    names = _grad_names(params, num_layers)
    flat = torch.zeros(sum(params[n].numel() for n in names) + extra, dtype=torch.float32,
                       device=params[names[0]].device)
    return flat, grad_views(params, num_layers, flat[:flat.numel() - extra])


def grad_views(params: Mapping[str, torch.Tensor], num_layers: int, flat: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """The views by name of a flat gradient buffer laid out as
    ``grad_buffer`` lays it out (``flat``: exactly the gradients)."""
    names = _grad_names(params, num_layers)
    return dict(zip(names, _views_of(flat, [params[n] for n in names])))


def _grad_names(params: Mapping[str, torch.Tensor], num_layers: int) -> list:
    """The order of ``grad_buffer``'s layout: ``_src_names`` for a trunk
    without LoRA, ``params``' own for a LoRA trunk."""
    names = list(_src_names(num_layers))
    return names if set(params) == set(names) else list(params)


def _views_of(flat: torch.Tensor, like) -> list:
    """Consecutive views of the flat ``flat`` shaped like the tensors of ``like``."""
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    if off != flat.numel():
        raise ValueError(f"a flat buffer of {flat.numel()} elements for {off}")
    return out
