"""The LoRA trunk's packing and its VJP on the kernel path:
``csrc/lora_pack.cu`` and their plain versions.

A ``NeRFMLP`` whose every trunk layer is a ``LoRADense`` (``trunk.{i}.base``,
``lora_a`` (in, r), ``lora_b`` (r, out)) reaches the trunk kernels through
the six tensors of ``pack_params``: every layer merged into ``W + (alpha / r)
* A @ B``, the first layer's rows gathered through ``row_perm`` and padded to
``d_pad``, the heads padded to 128 columns. ``lora_pack`` writes them with
``nerf_lora_pack_fwd``, bit-equal to the layer-by-layer packing
(``lora_pack_reference``, ``render/kernels.py:_pack_merged``) up to rank
1020; above it, where torch's sum on the card splits across blocks in an
order its launch heuristics choose, the kernel sums each merged element's
fp32 products in float64 and rounds once. ``lora_pack_vjp`` maps the
kernels' six packed gradients back to every parameter's gradient with
``nerf_lora_pack_vjp``, straight into a flat buffer in the state's order:
the base weights, the biases and the heads bit-equal to autograd through
the packing (``lora_pack_vjp_reference``), ``lora_a`` and ``lora_b`` (two
reductions) in float64, in a fixed order of their own. A training step
thus takes a LoRA trunk's gradients without the autograd engine, as a
trunk without LoRA does (``render/kernels.py:packed_grads``).

Both take any rank and any depth: a launch of either kernel takes at most
``LAYERS_PER_LAUNCH`` layers (its pointer table, passed by value, so that a
CUDA graph holds it as captured), and a trunk of L layers takes ceil(L /
``LAYERS_PER_LAUNCH``) launches of each, launch c the layers from
``LAYERS_PER_LAUNCH * c``; the last also writes the heads.

The kernels replace no Pallas kernel: they are the counterpart of XLA's
fusion of the JAX step's ``pack_params`` over a LoRA trunk
(``nerf_fewshot_tpu/render/kernels.py:660-710``) and of ``jax.vjp`` over it
(``nerf_fewshot_tpu/render/train_kernel.py:720-747``).

Both wrappers take ``plain``: ``True`` runs the plain version (the CPU's
route, on any device); otherwise the kernel, which needs a card: a CPU
tensor then raises, and so does a failed build or launch. Each launch adds
one to ``lora_pack.launches`` / ``lora_pack_vjp.launches``. ``lora_pack`` is
differentiable on both routes: the plain one by autograd, the kernel one
through ``_LoraPack``, whose backward is ``lora_pack_vjp``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nerf_fewshot_tpu_torch.render.kernels import (
    D_PAD,
    OUT_PAD,
    Packed,
    RowPerm,
    _canonical,
    _check_card,
    _check_width,
    _host_perm,
    _lib_fn,
    _pack_merged,
    _raise_on,
    to_device,
)

PARTS = ("lora_a", "lora_b", "base.weight", "base.bias")  # a LoRADense's parameters
HEADS = ("rgb_head.weight", "rgb_head.bias", "sigma_head.weight", "sigma_head.bias")
# csrc/lora_pack.cu:nerf_lora_pack_fwd(layers, heads, outs (host arrays of
# device pointers), row_perm, n_layers, first, count, hidden, in_dim, n_rows,
# d_pad, rank, scale, stream)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
FWD_ARGTYPES = [_PTRS] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
# nerf_lora_pack_vjp(lora, dpacked, grads, head_grads (host arrays), row_perm,
# n_layers, first, count, hidden, in_dim, n_rows, rank, scale, stream)
VJP_ARGTYPES = [_PTRS] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
LAYERS_PER_LAUNCH = 32  # csrc/lora_pack.cu:kMaxLayers, a launch's pointer table
# csrc/lora_pack.cu:kTorchOrderRank: up to this rank the packing follows the
# plain merge's sum order on the card, bit for bit; above it (torch's sum
# then splits across blocks) it sums each merged element in float64
TORCH_ORDER_RANK = 1020


def launch_layers(num_layers: int) -> List[Tuple[int, int]]:
    """``(first, count)`` of each launch that a ``num_layers`` trunk takes."""
    return [(first, min(LAYERS_PER_LAUNCH, num_layers - first))
            for first in range(0, num_layers, LAYERS_PER_LAUNCH)]


def lora_names(num_layers: int) -> Tuple[str, ...]:
    """Every parameter name of a LoRA trunk of ``num_layers`` layers."""
    return tuple(f"trunk.{i}.{p}" for i in range(num_layers) for p in PARTS) + HEADS


def is_lora_trunk(state: Mapping[str, torch.Tensor], num_layers: int) -> bool:
    """Whether ``state`` holds exactly a LoRA trunk's parameters."""
    return set(state) == set(lora_names(num_layers))


def packed_shapes(num_layers: int, hidden_dim: int, d_pad: int) -> Tuple[Tuple[int, ...], ...]:
    """The shapes of ``pack_params``' six tensors."""
    H, L1 = hidden_dim, num_layers - 1
    return (d_pad, H), (1, H), (L1, H, H), (L1, H), (H, OUT_PAD), (1, OUT_PAD)


def pack_buffer(num_layers: int, hidden_dim: int, d_pad: int, device) -> torch.Tensor:
    """A flat float32 buffer for ``lora_pack(out=)``."""
    n = sum(int(np.prod(s)) for s in packed_shapes(num_layers, hidden_dim, d_pad))
    return torch.zeros(n, dtype=torch.float32, device=device)


def _views(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """Consecutive views of the flat ``flat`` in ``shapes``; raises unless
    they cover it."""
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[off:off + n].view(s))
        off += n
    if flat.dim() != 1 or not flat.is_contiguous() or off != flat.numel():
        raise ValueError(f"a contiguous flat buffer of {off} elements expected; got "
                         f"{tuple(flat.shape)}, contiguous={flat.is_contiguous()}")
    return out


def lora_pack_reference(state: Mapping[str, torch.Tensor], num_layers: int, hidden_dim: int,
                        d_pad: int = D_PAD, row_perm: Optional[RowPerm] = None,
                        lora_alpha: float = 16.0) -> Packed:
    """The plain version: the layer-by-layer packing (``_pack_merged``),
    differentiable by autograd."""
    return _pack_merged(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha)


def lora_pack_vjp_reference(state: Mapping[str, torch.Tensor], dpacked: Packed, num_layers: int,
                            hidden_dim: int, row_perm: Optional[RowPerm] = None,
                            lora_alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """The plain version of the VJP: autograd through ``_pack_merged`` with
    the cotangents ``dpacked``; the gradients by name, in ``state``'s order,
    with the layouts autograd gives them."""
    names = list(state)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.items()}
        packed = _pack_merged(leaves, num_layers, hidden_dim, dpacked[0].shape[0], row_perm,
                              lora_alpha)
        # a 1-layer trunk's wh / bh are empty constants, outside the graph
        live = [(p, d) for p, d in zip(packed, dpacked) if p.requires_grad]
        grads = torch.autograd.grad([p for p, _ in live], [leaves[k] for k in names],
                                    [d for _, d in live])
    return dict(zip(names, grads))


class _Plan(NamedTuple):
    """A LoRA trunk checked for the kernels: its tensors in the C entries'
    order, the shapes and the device ``row_perm`` (or ``None``)."""

    device: torch.device
    layers: Tuple[torch.Tensor, ...]  # base.weight, base.bias, lora_a, lora_b per layer
    heads: Tuple[torch.Tensor, ...]  # HEADS order
    row_perm: Optional[torch.Tensor]
    in_dim: int
    rank: int
    scale: float


def _device_perm(row_perm: Optional[RowPerm], in_dim: int, device: torch.device,
                 caller: str) -> Optional[torch.Tensor]:
    """``row_perm`` as an int64 tensor on ``device`` (a host sequence copied
    there), checked to be a permutation of the ``in_dim`` input rows: the
    VJP un-permutes, which a repeated row would make a sum."""
    if row_perm is None:
        return None
    perm = _host_perm(row_perm)
    if not np.array_equal(np.sort(perm), np.arange(in_dim)):
        raise ValueError(f"{caller}: row_perm is not a permutation of the {in_dim} input rows")
    if isinstance(row_perm, torch.Tensor):
        if row_perm.device != device or row_perm.dtype != torch.int64 \
                or not row_perm.is_contiguous():
            raise ValueError(f"{caller}: a row_perm tensor must be contiguous int64 on {device}")
        return row_perm
    return to_device(perm, device)


def _plan(state: Mapping[str, torch.Tensor], num_layers: int, hidden_dim: int,
          row_perm: Optional[RowPerm], lora_alpha: float, caller: str) -> _Plan:
    """The kernels' checks of a LoRA trunk on a card: names, device, dtype,
    contiguity and shapes."""
    if num_layers < 1 or not is_lora_trunk(state, num_layers):
        raise ValueError(f"{caller}: the state is not a {num_layers}-layer LoRA trunk (every "
                         f"trunk layer a LoRADense, and the two heads)")
    device = _canonical(state["trunk.0.lora_a"].device)
    if device.type != "cuda":
        raise ValueError(f"{caller}: no kernel for device {device}; the plain version is "
                         f"plain=True")
    _check_card(device, caller)
    _check_width(hidden_dim, caller)
    H = hidden_dim
    in_dim, rank = state["trunk.0.lora_a"].shape
    for name in lora_names(num_layers):
        t = state[name]
        if _canonical(t.device) != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be a contiguous float32 tensor on "
                             f"{device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    for i in range(num_layers):
        fan_in = in_dim if i == 0 else H
        want = {"lora_a": (fan_in, rank), "lora_b": (rank, H), "base.weight": (H, fan_in),
                "base.bias": (H,)}
        for part, shape in want.items():
            got = tuple(state[f"trunk.{i}.{part}"].shape)
            if got != shape:
                raise ValueError(
                    f"{caller}: trunk.{i}.{part} has shape {got}, expected {shape} (a uniform "
                    f"{H}x{H} trunk of rank {rank}; skip connections are not supported by the "
                    f"fused kernels)")
    for name, shape in zip(HEADS, ((3, H), (3,), (1, H), (1,))):
        if tuple(state[name].shape) != shape:
            raise ValueError(f"{caller}: {name} has shape {tuple(state[name].shape)}, "
                             f"expected {shape}")
    layers = tuple(state[f"trunk.{i}.{p}"] for i in range(num_layers)
                   for p in ("base.weight", "base.bias", "lora_a", "lora_b"))
    return _Plan(device, layers, tuple(state[n] for n in HEADS),
                 _device_perm(row_perm, in_dim, device, caller), in_dim, rank,
                 float(np.float32(lora_alpha / rank)))


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_fwd(plan: _Plan, num_layers: int, hidden_dim: int, d_pad: int,
                out: Optional[torch.Tensor]) -> Packed:
    """The launches of ``nerf_lora_pack_fwd`` into ``out`` (or a new
    buffer), one per ``launch_layers`` entry."""
    if plan.in_dim > d_pad:
        raise ValueError(f"lora_pack: {plan.in_dim} input rows exceed d_pad={d_pad}")
    shapes = packed_shapes(num_layers, hidden_dim, d_pad)
    if out is None:
        out = torch.empty(sum(int(np.prod(s)) for s in shapes), dtype=torch.float32,
                          device=plan.device)
    elif out.device != plan.device or out.dtype != torch.float32:
        raise ValueError(f"lora_pack: out must be float32 on {plan.device}")
    packed = tuple(_views(out, shapes))
    lib, fn = _lib_fn("lora_pack", "nerf_lora_pack_fwd", FWD_ARGTYPES)
    perm = None if plan.row_perm is None else plan.row_perm.data_ptr()
    heads, outs = _ptrs(plan.heads), _ptrs(packed)
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    for first, count in launch_layers(num_layers):
        err = fn(_ptrs(plan.layers[4 * first:4 * (first + count)]), heads, outs, perm,
                 num_layers, first, count, hidden_dim, plan.in_dim, plan.in_dim, d_pad,
                 plan.rank, plan.scale, stream)
        _raise_on(err, lib, "lora_pack_fwd")
        lora_pack.launches += 1
    return packed


class _LoraPack(torch.autograd.Function):
    """``lora_pack`` on the kernel route, differentiable in every parameter:
    forward ``nerf_lora_pack_fwd``, backward ``nerf_lora_pack_vjp`` (the
    parameters as the forward saw them)."""

    @staticmethod
    def forward(ctx, spec, names, *srcs):
        state = dict(zip(names, srcs))
        num_layers, hidden_dim, d_pad, row_perm, lora_alpha = spec
        plan = _plan(state, num_layers, hidden_dim, row_perm, lora_alpha, "lora_pack")
        ctx.spec, ctx.names = spec, names
        ctx.save_for_backward(*srcs)
        return _launch_fwd(plan, num_layers, hidden_dim, d_pad, None)

    @staticmethod
    def backward(ctx, *dpacked):
        num_layers, hidden_dim, _, row_perm, lora_alpha = ctx.spec
        state = dict(zip(ctx.names, ctx.saved_tensors))
        grads = lora_pack_vjp(state, tuple(d.contiguous() for d in dpacked), num_layers,
                              hidden_dim, row_perm, lora_alpha)
        return (None, None, *(grads[n] for n in ctx.names))


def lora_pack(state: Mapping[str, torch.Tensor], num_layers: int, hidden_dim: int,
              d_pad: int = D_PAD, row_perm: Optional[RowPerm] = None, lora_alpha: float = 16.0,
              *, out: Optional[torch.Tensor] = None, plain: bool = False) -> Packed:
    """``pack_params`` of a LoRA trunk: ``(w0 (d_pad, H), b0 (1, H), wh
    (L-1, H, H), bh (L-1, H), wout (H, 128), bout (1, 128))``.

    ``plain``: the plain version (``lora_pack_reference``); otherwise the
    kernel on the state's card, one launch per ``launch_layers`` entry (a
    CPU state raises).
    ``row_perm``: ``pe_constants``' device tensor (or a host sequence), a
    permutation of the first layer's input rows. ``out``: a flat buffer of
    ``pack_buffer``'s size; the six tensors are written there and returned
    as its views (no gradient flows through them). Without ``out`` the
    result is differentiable in every parameter on either route."""
    if plain:
        packed = lora_pack_reference(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha)
        if out is None:
            return packed
        views = _views(out, [p.shape for p in packed])
        with torch.no_grad():
            torch._foreach_copy_(views, list(packed))
        return tuple(views)
    names = tuple(state)
    srcs = [state[n] for n in names]
    if out is None and torch.is_grad_enabled() and any(t.requires_grad for t in srcs):
        spec = (num_layers, hidden_dim, d_pad, row_perm, lora_alpha)
        return _LoraPack.apply(spec, names, *srcs)
    plan = _plan(state, num_layers, hidden_dim, row_perm, lora_alpha, "lora_pack")
    return _launch_fwd(plan, num_layers, hidden_dim, d_pad, out)


lora_pack.launches = 0


def lora_pack_vjp(state: Mapping[str, torch.Tensor], dpacked: Packed, num_layers: int,
                  hidden_dim: int, row_perm: Optional[RowPerm] = None, lora_alpha: float = 16.0,
                  *, out: Optional[torch.Tensor] = None, plain: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient, by name, from the gradients ``dpacked`` of
    ``lora_pack(state, ..., row_perm)``'s six tensors (``d_pad`` is
    ``dpacked[0]``'s row count).

    ``plain``: the plain version (``lora_pack_vjp_reference``; with ``out``
    the gradients are also copied there); otherwise the kernel, one launch
    per ``launch_layers`` entry, which writes every gradient into ``out``
    (a flat float32 buffer
    of the parameters' numel, each contiguous in its parameter's shape, in
    ``state``'s order) or a new such buffer, and returns its views."""
    names = list(state)
    if plain:
        grads = lora_pack_vjp_reference(state, dpacked, num_layers, hidden_dim, row_perm,
                                        lora_alpha)
        if out is not None:
            with torch.no_grad():
                torch._foreach_copy_(_views(out, [state[k].shape for k in names]),
                                     [grads[k] for k in names])
        return grads
    caller = "lora_pack_vjp"
    plan = _plan(state, num_layers, hidden_dim, row_perm, lora_alpha, caller)
    d_pad = dpacked[0].shape[0]
    for d, shape, what in zip(dpacked, packed_shapes(num_layers, hidden_dim, d_pad),
                              ("gw0", "gb0", "gwh", "gbh", "gwout", "gbout")):
        if (tuple(d.shape) != shape or _canonical(d.device) != plan.device
                or d.dtype != torch.float32 or not d.is_contiguous()):
            raise ValueError(f"{caller}: {what} must be a contiguous float32 {shape} tensor on "
                             f"{plan.device}; got {d.dtype} {tuple(d.shape)} on {d.device}")
    if plan.in_dim > d_pad:
        raise ValueError(f"{caller}: {plan.in_dim} input rows exceed d_pad={d_pad}")
    if out is None:
        out = torch.empty(sum(state[k].numel() for k in names), dtype=torch.float32,
                          device=plan.device)
    elif out.device != plan.device or out.dtype != torch.float32:
        raise ValueError(f"{caller}: out must be float32 on {plan.device}")
    grads = dict(zip(names, _views(out, [state[k].shape for k in names])))
    lora = [grads[f"trunk.{i}.{p}"] for i in range(num_layers) for p in
            ("base.weight", "base.bias", "lora_a", "lora_b")]
    srcs = [state[f"trunk.{i}.{p}"] for i in range(num_layers) for p in ("lora_a", "lora_b")]
    lib, fn = _lib_fn("lora_pack", "nerf_lora_pack_vjp", VJP_ARGTYPES)
    perm = None if plan.row_perm is None else plan.row_perm.data_ptr()
    packed, heads = _ptrs(dpacked), _ptrs([grads[n] for n in HEADS])
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    for first, count in launch_layers(num_layers):
        err = fn(_ptrs(srcs[2 * first:2 * (first + count)]), packed,
                 _ptrs(lora[4 * first:4 * (first + count)]), heads, perm, num_layers, first,
                 count, hidden_dim, plan.in_dim, plan.in_dim, plan.rank, plan.scale, stream)
        _raise_on(err, lib, "lora_pack_vjp")
        lora_pack_vjp.launches += 1
    return grads


lora_pack_vjp.launches = 0
