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
* ``AdamKernel`` takes an ``adam`` / ``adamw`` optimizer's whole step in
  one launch of ``csrc/adam.cu``, bit-equal to the eager foreach step, its
  per-step scalars read from a device table filled once per epoch
  (``adam_step_scalars``): the step the trainer's CUDA graph replays.
* ``lora_only`` is the JAX package's ``optax.multi_transform`` with
  ``set_to_zero`` on the ``base`` labels (``lora_label_fn``): the
  optimizer holds the ``lora`` parameters alone, so the clip and the
  weight decay act on them only, the base parameters and heads never move,
  and Adam's moments and step count start fresh.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
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
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         norm_grads: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Scale every ``.grad`` in place by ``max_norm / ||g||`` when the global
    norm reaches ``max_norm`` (optax's rule: ``t / ||g|| * max_norm``).
    Stream-ordered: the choice is a select on the device, so the host never
    waits for the norm; a gradient below the limit keeps its bits.
    ``norm_grads``: the same gradients in the layouts whose order the norm
    sums in (a reduction sums in memory order): the trainer passes them as
    the kernel gave them, so the norm keeps its bits whatever the layout of
    the ``.grad`` buffers; by default the ``.grad`` themselves."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    squares = grads if norm_grads is None else norm_grads
    norm = torch.sqrt(sum(torch.sum(g * g) for g in squares))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(
    cfg: OptimizerConfig,
    params: Iterable[Union[torch.nn.Parameter, Tuple[str, torch.nn.Parameter]]],
    lora_only: bool = False,
    clip_hook: bool = True,
) -> torch.optim.Optimizer:
    """The configured optimizer over ``params`` (parameters, or ``(name,
    parameter)`` pairs as ``named_parameters()`` gives them), with the
    global-norm clip registered as a step pre-hook when ``cfg.grad_clip >
    0`` and ``clip_hook`` (the trainer clips before each step itself).
    ``lora_only`` keeps the parameters whose name ``lora_label_fn`` labels
    ``lora`` and needs the names."""
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
    if cfg.grad_clip > 0 and clip_hook:
        max_norm = float(cfg.grad_clip)
        opt.register_step_pre_hook(lambda o, args, kwargs: clip_by_global_norm_(
            [p for g in o.param_groups for p in g["params"]], max_norm))
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every param group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


# csrc/adam.cu:nerf_adam_step(table, n_tensors, n_blocks, scalars, counter,
# wd, w1, beta2, 1 - beta2, eps, adamw, stream)
ADAM_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                 + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
SCALARS_PER_STEP = 3  # step size, sqrt of the second bias correction, 1 - lr * wd


def _state_step(optimizer: torch.optim.Optimizer) -> float:
    """The step count every parameter of the optimizer's group shares (0.0
    before its first step); raises if they differ."""
    steps = {float(optimizer.state[p]["step"]) if "step" in optimizer.state[p] else 0.0
             for p in optimizer.param_groups[0]["params"]}
    if len(steps) > 1:
        raise ValueError(f"the optimizer's parameters are at different steps {sorted(steps)}")
    return steps.pop() if steps else 0.0


def adam_step_scalars(optimizer: torch.optim.Optimizer, n_steps: int) -> np.ndarray:
    """The (n_steps, 3) fp32 table of the optimizer's next ``n_steps`` steps
    at its group's current lr: per step ``t`` the step size ``(lr / (1 -
    beta1 ** t)) * -1``, ``(1 - beta2 ** t) ** 0.5`` and ``1 - lr * wd``,
    each a float64 Python expression cast to fp32 to nearest, as
    ``_multi_tensor_adam`` computes them and as torch casts a Python scalar
    for its foreach kernels."""
    group = optimizer.param_groups[0]
    lr, (beta1, beta2), wd = group["lr"], group["betas"], group["weight_decay"]
    t0 = _state_step(optimizer)
    rows = []
    for k in range(1, n_steps + 1):
        step = t0 + k
        rows.append(((lr / (1 - beta1 ** step)) * -1, (1 - beta2 ** step) ** 0.5, 1 - lr * wd))
    return np.asarray(rows, np.float32).reshape(n_steps, SCALARS_PER_STEP)


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter without state the state torch's Adam makes at its
    first step (``step`` a 0-d CPU tensor, zero moments like the parameter),
    so that a kernel can hold their pointers before that step."""
    for p in optimizer.param_groups[0]["params"]:
        state = optimizer.state[p]
        if len(state) == 0:
            state["step"] = torch.tensor(0.0, dtype=torch.get_default_dtype())
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


class AdamKernel:
    """``optimizer.step()`` of an ``adam`` / ``adamw`` optimizer (one group, as
    ``make_optimizer`` builds it, no clip hook) as one launch of
    ``csrc/adam.cu:nerf_adam_step`` over all its parameters, bit-equal to
    torch's eager foreach step, for the trainer's CUDA graph.

    ``grads``: each parameter's gradient buffer (contiguous, the same every
    step; the parameters' ``.grad``); ``device`` by default the
    parameters'. The launch reads the parameters, gradients and moments
    through a device table of their pointers, made here (so a later replacement of a moment, by ``load_state_dict``, needs
    a new ``AdamKernel``), and its per-step scalars from row ``counter[0]``
    of ``scalars``, which ``begin_epoch`` fills (``adam_step_scalars``) for
    an epoch's steps; the kernel moves ``counter[0]`` on. On CPU tensors
    ``step`` runs the plain version, ``optimizer.step()``, and moves the
    counter; on a card it launches the kernel and counts one in
    ``AdamKernel.launches``, and ``end_epoch`` moves each ``state["step"]``
    on by the steps taken, as the eager step would have."""

    launches = 0

    def __init__(self, optimizer: torch.optim.Optimizer, grads: Sequence[torch.Tensor],
                 max_steps: int, device: Optional[torch.device] = None):
        if type(optimizer) not in (torch.optim.Adam, torch.optim.AdamW):
            raise ValueError(f"AdamKernel: {type(optimizer).__name__} is not Adam or AdamW")
        if len(optimizer.param_groups) != 1:
            raise ValueError("AdamKernel: the optimizer must have one param group")
        group = optimizer.param_groups[0]
        if group["amsgrad"] or group["maximize"] or group.get("capturable") or group.get("fused"):
            raise ValueError("AdamKernel: amsgrad, maximize, capturable and fused are not taken")
        if group["foreach"] is False:
            raise ValueError("AdamKernel: the plain version is the foreach step")
        if optimizer._optimizer_step_pre_hooks:
            raise ValueError("AdamKernel: the optimizer has step pre-hooks (make it with "
                             "clip_hook=False and clip before the step)")
        self.optimizer = optimizer
        self.params: List[torch.Tensor] = list(group["params"])
        self.grads = list(grads)
        if len(self.grads) != len(self.params):
            raise ValueError("AdamKernel: one gradient buffer per parameter")
        self.adamw = isinstance(optimizer, torch.optim.AdamW)
        init_adam_state(optimizer)
        self.moments = ([optimizer.state[p]["exp_avg"] for p in self.params],
                        [optimizer.state[p]["exp_avg_sq"] for p in self.params])
        if device is None:
            if not self.params:
                raise ValueError("AdamKernel: an optimizer without parameters needs a device")
            device = self.params[0].device
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # as the tensors name it
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.scalars = torch.zeros((max(max_steps, 1), SCALARS_PER_STEP), dtype=torch.float32,
                                   device=device)
        self.counter = torch.zeros(2, dtype=torch.int64, device=device)  # step index, blocks done
        self.table = None
        self.n_blocks = 0
        if device.type == "cuda" and self.params:
            self._make_table()

    def is_current(self, optimizer: torch.optim.Optimizer) -> bool:
        """Whether this kernel's table still points at ``optimizer``'s
        tensors: the same optimizer, parameters, ``.grad`` buffers and
        moments (a ``load_state_dict`` replaces the moments)."""
        params = optimizer.param_groups[0]["params"]
        if optimizer is not self.optimizer or len(params) != len(self.params):
            return False
        for p, q, g, m, v in zip(params, self.params, self.grads, *self.moments):
            state = optimizer.state.get(p, {})
            if p is not q or p.grad is not g or state.get("exp_avg") is not m \
                    or state.get("exp_avg_sq") is not v:
                return False
        return True

    def _make_table(self) -> None:
        from nerf_fewshot_tpu_torch.render.kernels import _check_card, _lib_fn, to_device

        _check_card(self.device, "AdamKernel")
        lib, _ = _lib_fn("adam", "nerf_adam_step", ADAM_ARGTYPES)
        lib.nerf_adam_chunk.restype = ctypes.c_int
        chunk = lib.nerf_adam_chunk()
        rows, first = [], 0
        for p, g in zip(self.params, self.grads):
            st = self.optimizer.state[p]
            for t, what in ((p, "parameter"), (g, "gradient"), (st["exp_avg"], "exp_avg"),
                            (st["exp_avg_sq"], "exp_avg_sq")):
                if (t.device != self.device or t.dtype != torch.float32
                        or not t.is_contiguous() or t.shape != p.shape):
                    raise ValueError(f"AdamKernel: each {what} must be a contiguous float32 "
                                     f"tensor of its parameter's shape on {self.device}")
            rows.append([p.data_ptr(), g.data_ptr(), st["exp_avg"].data_ptr(),
                         st["exp_avg_sq"].data_ptr(), p.numel(), first])
            first += -(-p.numel() // chunk)
        self.table = to_device(np.asarray(rows, np.int64), self.device)
        self.n_blocks = first

    def begin_epoch(self, n_steps: int) -> None:
        """Fill the scalars of the next ``n_steps`` steps (the group's lr as it
        is now) by one stream-ordered copy and set the step index to 0."""
        if n_steps > self.scalars.shape[0]:
            raise ValueError(f"AdamKernel: {n_steps} steps exceed the table's "
                             f"{self.scalars.shape[0]}")
        from nerf_fewshot_tpu_torch.render.kernels import to_device

        self.scalars[:n_steps].copy_(to_device(adam_step_scalars(self.optimizer, n_steps),
                                               self.device))
        self.counter.zero_()

    def step(self) -> None:
        """One step of every parameter: the kernel on a card, the plain
        version (torch's step) on the CPU. An optimizer without parameters
        (a trunk without LoRA frozen whole) only moves the step index on."""
        if self.device.type == "cpu" or not self.params:
            self.optimizer.step()
            self.counter[0] += 1
            return
        from nerf_fewshot_tpu_torch.render.kernels import _lib_fn, _raise_on

        lib, fn = _lib_fn("adam", "nerf_adam_step", ADAM_ARGTYPES)
        group = self.optimizer.param_groups[0]
        beta1, beta2 = group["betas"]
        scalar = lambda x: float(np.float32(x))  # torch's cast of a Python scalar
        err = fn(self.table.data_ptr(), len(self.params), self.n_blocks,
                 self.scalars.data_ptr(), self.counter.data_ptr(),
                 scalar(group["weight_decay"]), scalar(1 - beta1), scalar(beta2),
                 scalar(1 - beta2), scalar(group["eps"]), int(self.adamw),
                 torch.cuda.current_stream(self.device).cuda_stream)
        _raise_on(err, lib, "adam")
        AdamKernel.launches += 1

    def end_epoch(self, n_steps: int) -> None:
        """After ``n_steps`` kernel steps: each parameter's ``state["step"]``
        moved on as the eager step moves it (a host tensor: no copy). The
        plain version moves it itself."""
        if self.device.type != "cpu":
            for p in self.params:
                self.optimizer.state[p]["step"] += n_steps
