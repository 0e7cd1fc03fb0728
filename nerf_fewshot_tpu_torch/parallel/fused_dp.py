"""Data-parallel wrapper for the fused train-step kernel (counterpart of
``nerf_fewshot_tpu/parallel/fused_dp.py``).

Each rank runs the training objective (kernel 1 on a card, its plain
version on the CPU) on its shard of the ray batch, normalized by the
*global* valid-ray count, and the loss and every gradient are then summed
over the ranks in one in-place all-reduce of one flat buffer: the gradients
in ``grad_buffer``'s layout, the loss in the slot after them. The sum of
the shards' terms is the single-device masked mean, up to the order of the
sums. The trainer's eager mesh step and its CUDA graph (on NCCL) reduce the
same buffer, so NCCL splits it the same way in both and they agree bit for
bit at any world size.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from nerf_fewshot_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, all_reduce_sum_
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.render.train_kernel import (
    fused_train_loss_grad,
    grad_buffer as make_grad_buffer,
    grad_views,
)


def make_dp_fused_loss_grad(
    mesh: Mesh,
    settings: RenderSettings,
    pos_freq: int,
    dir_freq: int,
    num_layers: int,
    hidden_dim: int,
    use_viewdirs: bool = True,
    lora_alpha: float = 16.0,
    compute_dtype: str = "float32",
    point_features_builder: Optional[Callable] = None,
    reg_weight: float = 0.0,
    rgb_weight: float = 1.0,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Build ``(params, uniforms, rays_o, rays_d, target, mask[, feat_map,
    feat_pose], importance_uniforms=None, denom_rays=None, grad_buffer=None)
    -> (loss, grads)``: the rays, targets, mask and uniforms are this rank's
    rows; the outputs are the sums over the ranks, the same on every rank.

    The JAX function's arguments, but for two: ``interpret`` (CPU tensors
    run the kernel's plain version, CUDA tensors the kernel) and
    ``axis_name`` (the mesh has one axis). The JAX function folds the
    device index into its key; here the caller gives each rank its rows of
    the batch's ``uniforms`` (``None`` without jitter). ``rgb_weight``
    scales the rgb term, as the port's ``fused_train_loss_grad`` does.

    ``denom_rays``: the batch's valid-ray count, from a caller that holds
    the whole batch's mask (the trainer: a sum of 0/1 values below 2^24 is
    exact in any order, so it equals the all-reduced count bit for bit);
    without it the count is all-reduced, as the JAX function's ``psum``.
    ``grad_buffer``: a flat float32 buffer of ``grad_buffer(params,
    num_layers, extra=1)``'s layout (the trainer's, whose views are the
    parameters' ``.grad``); the kernel's gradients land there, the loss in
    its last element, and both are summed over the ranks in place by one
    all-reduce (``all_reduce_sum_``). Without it the call makes one. The
    returned gradients are the buffer's views, the loss a copy.

    ``point_features_builder(*feat) -> (pts -> features)``: per-point DINO
    conditioning (the JAX function's ``(feat_map, feat_pose)``; the trainer
    passes its ``feature_sampler`` and a view index). The returned callable
    then takes ``feat``, replicated, as its trailing arguments and samples
    on the rank's shard, with no collective."""

    def fn(params, uniforms, rays_o, rays_d, target, mask, *feat,
           importance_uniforms: Optional[torch.Tensor] = None,
           denom_rays: Optional[torch.Tensor] = None,
           grad_buffer: Optional[torch.Tensor] = None):
        named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
        if denom_rays is None:
            (denom_rays,) = all_reduce_sum(mesh, [torch.sum(mask).reshape(1)])
            denom_rays = denom_rays.reshape(())
        if grad_buffer is None:
            grad_buffer, _ = make_grad_buffer(named, num_layers, extra=1)
        grads = grad_buffer[:-1]
        pf = point_features_builder(*feat) if point_features_builder is not None else None
        loss, _ = fused_train_loss_grad(
            params, rays_o, rays_d, target, mask, settings, pos_freq, dir_freq, num_layers,
            hidden_dim, use_viewdirs=use_viewdirs, compute_dtype=compute_dtype,
            uniforms=uniforms, denom_rays=denom_rays, point_features_fn=pf,
            reg_weight=reg_weight, rgb_weight=rgb_weight,
            importance_uniforms=importance_uniforms, lora_alpha=lora_alpha,
            grad_buffer=grads)
        grad_buffer[-1:].copy_(loss.reshape(1))
        all_reduce_sum_(mesh, grad_buffer)
        return grad_buffer[-1].clone(), grad_views(named, num_layers, grads)

    return fn
