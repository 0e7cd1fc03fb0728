"""Optimizers and LR schedules (counterpart of
``nerf_fewshot_tpu/training/optim.py``).

* ``kind='adam'`` is ``torch.optim.Adam(weight_decay=wd)``: L2 decay added
  to the gradient before the moments, which is what the JAX package builds
  as ``add_decayed_weights`` in front of ``scale_by_adam``.
* ``kind='adamw'`` is ``torch.optim.AdamW``. The JAX chain adds ``wd * p``
  after the Adam scaling and multiplies the sum by ``-lr``; AdamW first
  scales ``p`` by ``1 - lr * wd`` and then takes the Adam step. Both give
  ``p - lr * (adam + wd * p)``: the same update, rounded in another order.
* ``grad_clip > 0`` clips by the global norm exactly as
  ``optax.clip_by_global_norm``: ``g * c / ||g||`` when ``||g|| >= c``,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
* The learning rate is a per-epoch MultiStep schedule set through
  ``set_learning_rate``.
* ``lora_only`` is the JAX package's ``optax.multi_transform`` with
  ``set_to_zero`` on the ``base`` labels (``lora_label_fn``): the
  optimizer holds the ``lora`` parameters alone, so the clip and the
  weight decay act on them only, the base parameters and heads never move,
  and Adam's moments and step count start fresh.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple, Union

import torch

from nerf_fewshot_tpu_torch.models.lora import lora_label_fn
from nerf_fewshot_tpu_torch.training.config import OptimizerConfig


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float):
    """epoch -> lr, torch MultiStepLR semantics (decays at each milestone)."""

    def lr_at(epoch: int) -> float:
        lr = base_lr
        for m in milestones:
            if epoch >= m:
                lr *= gamma
        return lr

    return lr_at


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale every ``.grad`` in place by ``max_norm / ||g||`` when the global
    norm reaches ``max_norm`` (optax's rule: ``t / ||g|| * max_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if not bool(norm < max_norm):
        for g in grads:
            g.div_(norm).mul_(max_norm)


def make_optimizer(
    cfg: OptimizerConfig,
    params: Iterable[Union[torch.nn.Parameter, Tuple[str, torch.nn.Parameter]]],
    lora_only: bool = False,
) -> torch.optim.Optimizer:
    """The configured optimizer over ``params`` (parameters, or ``(name,
    parameter)`` pairs as ``named_parameters()`` gives them), with the
    global-norm clip registered as a step pre-hook when ``cfg.grad_clip >
    0``. ``lora_only`` keeps the parameters whose name ``lora_label_fn``
    labels ``lora`` and needs the names."""
    params = list(params)
    named = [p for p in params if isinstance(p, tuple)]
    if lora_only:
        if len(named) != len(params):
            raise TypeError("make_optimizer(lora_only=True) labels parameters by name: "
                            "pass named_parameters()")
        params = [p for name, p in named if lora_label_fn(name) == "lora"]
    else:
        params = [p[1] if isinstance(p, tuple) else p for p in params]
    # one group even when it is empty: a model without LoRA layers then
    # freezes whole, as set_to_zero on every leaf does
    groups = [{"params": params}]
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.kind == "adam":
        opt = torch.optim.Adam(groups, **kw)
    elif cfg.kind == "adamw":
        opt = torch.optim.AdamW(groups, **kw)
    else:
        raise ValueError(f"unknown optimizer kind: {cfg.kind}")
    if cfg.grad_clip > 0:
        max_norm = float(cfg.grad_clip)
        opt.register_step_pre_hook(lambda o, args, kwargs: clip_by_global_norm_(
            [p for g in o.param_groups for p in g["params"]], max_norm))
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every param group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
