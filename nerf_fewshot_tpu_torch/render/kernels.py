"""The forward render kernels, the render VJP kernel and their host glue
(counterpart of ``nerf_fewshot_tpu/render/kernels.py``: ``pe_layout``,
``_raw_block``, ``pack_params``, ``fused_render_fwd_pe`` around
``_fwd_pe_kernel``, and ``fused_render`` around ``_fwd_kernel`` with its
custom VJP around ``_bwd_kernel``).

Every wrapper launches its CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; there is no other route: a CUDA tensor on a
card that is not sm_90 raises, any other device raises.
- ``fused_render_fwd_pe``: ``csrc/fwd_pe.cu:nerf_fwd_pe`` (kernel 2) /
  ``fused_render_fwd_pe_reference``;
- ``fused_render_fwd``: ``csrc/fwd_pe.cu:nerf_fwd_x`` (kernel 4) /
  ``fused_render_reference``;
- ``fused_render_bwd``: ``csrc/train_pe.cu:nerf_render_bwd`` (kernel 3) /
  ``fused_render_bwd_reference``;
- ``fused_render``: the differentiable render (``_FusedRender``), kernel 4
  forward and kernel 3 backward.
Each takes ``compute_dtype`` (``ROUTES``): ``float32``, ``bfloat16`` or
``highest``, the JAX kernels' precision modes; the kernels take the route as
an int, the plain versions round as that route rounds (``_dot``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nerf_fewshot_tpu_torch.render import cuda_build

# Input widths. The pre-encoded x of kernels 3, 4 and 5 is any multiple of
# D_PAD (``encode_points`` pads to one, as the JAX kernels do), which keeps
# the 64-column dx tiles of kernel 3 whole; the inline-PE input of kernels 1
# and 2 is padded to a multiple of PE_ALIGN (``pe_width``). As the JAX
# kernels, all five take any such width, any number of samples per ray, any
# trunk depth and any trunk width that is a multiple of H_ALIGN (each of 128
# to 512 a build of its own, every wider one the width-generic build); the
# R*S points are counted in 32-bit ints (MAX_POINTS).
D_PAD = 128
PE_ALIGN = 16
OUT_PAD = 128  # packed head columns: [r, g, b, sigma, 0...]
H_ALIGN = 128  # trunk widths: any multiple, the JAX kernels' check
MAX_POINTS = 2 ** 31 - 1 - 64  # R*S, padded to whole 64-point tiles, fits an int
# csrc/fwd_pe.cu:nerf_fwd_pe(17 pointers (the last the scratch), 11 ints, stream)
FWD_PE_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# csrc/fwd_pe.cu:nerf_fwd_x(14 pointers (the last the scratch), 8 ints, stream)
FWD_X_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# csrc/train_pe.cu:nerf_render_bwd(16 pointers, 8 ints, stream)
RENDER_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pe_layout(pos_freq: int, dir_freq: int, use_viewdirs: bool, feat_dim: int):
    """Host-side constants of the kernel's input layout
    ``[pts(3) | dirs(3)? | sin(phases) | feats | pad]``, where
    ``phases = C + raw @ E2`` covers sin-pos, cos-pos (pi/2 offset),
    sin-dir, cos-dir, 3 columns per frequency.

    Returns ``(row_perm, E2 (n_raw, n_phase), C (1, n_phase), x_dim)``;
    ``row_perm`` maps kernel-layout row -> canonical NeRFMLP input row.
    """
    n_raw = 6 if use_viewdirs else 3
    P, Dq = pos_freq, (dir_freq if use_viewdirs else 0)
    n_phase = 6 * P + 6 * Dq
    E2 = np.zeros((n_raw, n_phase), np.float32)
    C = np.zeros((1, n_phase), np.float32)
    half = np.float32(np.pi / 2)

    canon_dir = 3 * (2 * P + 1)
    perm = list(range(3))
    if use_viewdirs:
        perm += [canon_dir + d for d in range(3)]
    col = 0
    for trig in range(2):  # 0 = sin, 1 = cos
        for f in range(P):
            for d in range(3):
                E2[d, col] = 2.0 ** f
                C[0, col] = half * trig
                perm.append(3 + 6 * f + 3 * trig + d)
                col += 1
    if use_viewdirs:
        for trig in range(2):
            for f in range(Dq):
                for d in range(3):
                    E2[3 + d, col] = 2.0 ** f
                    C[0, col] = half * trig
                    perm.append(canon_dir + 3 + 6 * f + 3 * trig + d)
                    col += 1
    # Without viewdirs the canonical input has no dir block at all.
    canon_feat = canon_dir + (3 * (2 * Dq + 1) if use_viewdirs else 0)
    perm += [canon_feat + k for k in range(feat_dim)]
    return np.asarray(perm, np.int64), E2, C, n_raw + n_phase + feat_dim


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of the host array ``a`` on ``device`` that makes the host wait
    for nothing: on a card the array is staged in pinned memory and copied
    with ``non_blocking`` (stream-ordered; the pinned block is kept until
    the copy has run), elsewhere copied as it is."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PEConstants(NamedTuple):
    """``pe_layout``'s constants as tensors on one device: ``row_perm``
    (int64), ``e2`` and ``c`` (fp32), and ``x_dim``."""

    row_perm: torch.Tensor
    e2: torch.Tensor
    c: torch.Tensor
    x_dim: int


_PE_CONSTANTS: Dict[tuple, PEConstants] = {}
# id(row_perm tensor) -> (the tensor, its host values): pack_params plans its
# gather from the host values without reading the device.
_HOST_PERM: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def pe_constants(pos_freq: int, dir_freq: int, use_viewdirs: bool, feat_dim: int,
                 device) -> PEConstants:
    """``pe_layout``'s ``(row_perm, E2, C, x_dim)`` on ``device``, made once
    per device and layout (``to_device``) and the same tensors on every
    later call, so a step or an eval chunk copies nothing to the card."""
    device = _canonical(device)
    key = (pos_freq, dir_freq, bool(use_viewdirs), feat_dim, device)
    consts = _PE_CONSTANTS.get(key)
    if consts is None:
        perm, e2, c, x_dim = pe_layout(pos_freq, dir_freq, use_viewdirs, feat_dim)
        consts = PEConstants(to_device(perm, device), to_device(e2, device),
                             to_device(c, device), x_dim)
        _HOST_PERM[id(consts.row_perm)] = (consts.row_perm, perm)
        _PE_CONSTANTS[key] = consts
    return consts


def pe_width(x_dim: int) -> int:
    """The padded width D of the inline-PE kernels' input for ``x_dim``
    live columns: the next multiple of ``PE_ALIGN`` (176 for the 166
    columns of pos_freq 12 with 64-wide features, 240 for 230 with 128).
    The JAX package pads to a multiple of 128; the pad rows of ``w0`` and
    columns of x are zero either way, so the result is the same."""
    return -(-x_dim // PE_ALIGN) * PE_ALIGN


def _raw_block(pts: torch.Tensor, rays_d: torch.Tensor, use_viewdirs: bool) -> torch.Tensor:
    """(R, S, 3) points [+ per-sample ray dirs] -> the thin (R*S, n_raw)
    block the inline-PE kernel reads."""
    R, S, _ = pts.shape
    blocks = [pts.reshape(-1, 3)]
    if use_viewdirs:
        blocks.append(rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3))
    return torch.cat(blocks, dim=-1).contiguous()


def _trunk_layer(state: Mapping[str, torch.Tensor], i: int, lora_alpha: float):
    """Trunk layer ``i``'s (in, out) kernel and bias. A LoRA layer
    (``trunk.{i}.base``, ``lora_a`` (in, r), ``lora_b`` (r, out)) is merged
    into ``W + (lora_alpha / r) * A @ B``; the product is taken as r exact
    fp32 outer products summed on the CUDA cores, so no TF32 setting of
    cuBLAS reaches it."""
    if f"trunk.{i}.base.weight" not in state:
        return state[f"trunk.{i}.weight"].T, state[f"trunk.{i}.bias"]
    a, b = state[f"trunk.{i}.lora_a"], state[f"trunk.{i}.lora_b"]
    ab = torch.sum(a[:, :, None] * b[None, :, :], dim=1)
    return (state[f"trunk.{i}.base.weight"].T + (lora_alpha / a.shape[1]) * ab,
            state[f"trunk.{i}.base.bias"])


RowPerm = Union[Sequence[int], np.ndarray, torch.Tensor]


def _host_perm(row_perm: RowPerm) -> np.ndarray:
    """The values of ``row_perm``: a ``pe_constants`` tensor's from the
    host copy kept beside it, any other's read from its device."""
    if isinstance(row_perm, torch.Tensor):
        known = _HOST_PERM.get(id(row_perm))
        if known is not None and known[0] is row_perm:
            return known[1]
        return row_perm.detach().cpu().numpy().astype(np.int64)
    return np.asarray(row_perm, np.int64)


@functools.lru_cache(maxsize=None)
def _src_names(num_layers: int) -> Tuple[str, ...]:
    """The state-dict entries a trunk without LoRA packs from, in the order
    ``_GatherPack`` takes them."""
    names = []
    for i in range(num_layers):
        names += [f"trunk.{i}.weight", f"trunk.{i}.bias"]
    return tuple(names + ["rgb_head.weight", "rgb_head.bias", "sigma_head.weight",
                          "sigma_head.bias"])


class _PackPlan(NamedTuple):
    """Where each packed element comes from: ``fwd`` indexes the sources
    flattened in ``_src_names`` order with one zero appended (the pads).
    ``w0_rows``: with ``row_perm``, for each input row of the first layer
    its row in ``w0`` (the permutation's inverse; ``None`` without
    ``row_perm``). ``bwd``: the inverse of ``fwd``, for each source element
    in that order its place in the six packed tensors flattened one after
    the other (every source element is packed once)."""

    fwd: torch.Tensor
    shapes: Tuple[Tuple[int, ...], ...]
    in_dim: int
    w0_rows: Optional[torch.Tensor]
    bwd: torch.Tensor


_PACK_PLANS: Dict[tuple, _PackPlan] = {}
_ZEROS: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}


def _zero(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A cached one-element zero (never written)."""
    key = (device, dtype)
    if key not in _ZEROS:
        _ZEROS[key] = torch.zeros(1, dtype=dtype, device=device)
    return _ZEROS[key]


def _pack_plan(src_shapes, hidden_dim: int, d_pad: int, perm: Optional[np.ndarray],
               device: torch.device) -> _PackPlan:
    """The gather of ``pack_params`` for a trunk without LoRA, built on the
    host once per shapes, ``d_pad``, ``row_perm`` and device."""
    key = (src_shapes, hidden_dim, d_pad, None if perm is None else perm.tobytes(), device)
    plan = _PACK_PLANS.get(key)
    if plan is not None:
        return plan
    H = hidden_dim
    offs = np.cumsum([0] + [int(np.prod(s)) for s in src_shapes])
    zero = int(offs[-1])
    L = (len(src_shapes) - 4) // 2
    in_dim = src_shapes[0][1]
    rows = np.arange(in_dim) if perm is None else perm
    cols = np.arange(H)
    w0 = np.full((d_pad, H), zero, np.int64)
    w0[: len(rows)] = offs[0] + cols[None, :] * in_dim + rows[:, None]  # W0.T[rows]
    b0 = offs[1] + cols[None, :]
    wh = np.stack([offs[2 * i] + cols[None, :] * H + cols[:, None] for i in range(1, L)]) \
        if L > 1 else np.zeros((0, H, H), np.int64)
    bh = np.stack([offs[2 * i + 1] + cols for i in range(1, L)]) if L > 1 else \
        np.zeros((0, H), np.int64)
    wout = np.full((H, OUT_PAD), zero, np.int64)
    wout[:, :3] = offs[2 * L] + np.arange(3)[None, :] * H + cols[:, None]
    wout[:, 3] = offs[2 * L + 2] + cols
    bout = np.full((1, OUT_PAD), zero, np.int64)
    bout[0, :3] = offs[2 * L + 1] + np.arange(3)
    bout[0, 3] = offs[2 * L + 3]
    parts = (w0, b0, wh, bh, wout, bout)
    fwd = np.concatenate([p.reshape(-1) for p in parts])
    live = np.nonzero(fwd != zero)[0]
    bwd = np.empty(zero, np.int64)
    bwd[fwd[live]] = live
    plan = _PackPlan(to_device(fwd, device), tuple(p.shape for p in parts), in_dim,
                     None if perm is None else to_device(np.argsort(perm), device),
                     to_device(bwd, device))
    _PACK_PLANS[key] = plan
    return plan


class _GatherPack(torch.autograd.Function):
    """``pack_params`` of a trunk without LoRA as one gather from the
    flattened sources (two launches), and its backward as the views of the
    packed gradients that the per-layer transposes, stacks and
    concatenations it replaces gave back, with their strides, and the row
    gather's backward (``w0_rows``: a gather plus the +0.0 that its
    accumulation onto zeros added, which turns a -0.0 into +0.0; no launch
    without ``row_perm``, two with it). Pure data movement: the tensors,
    the gradients and their layouts are the per-layer packing's, bit for
    bit."""

    @staticmethod
    def forward(ctx, plan: _PackPlan, *srcs):
        ctx.plan = plan
        zero = _zero(srcs[0].device, srcs[0].dtype)
        flat = torch.cat([s.reshape(-1) for s in srcs] + [zero]).index_select(0, plan.fwd)
        sizes = [int(np.prod(s)) for s in plan.shapes]
        return tuple(t.view(s) for t, s in zip(torch.split(flat, sizes), plan.shapes))

    @staticmethod
    def backward(ctx, *dpacked):
        return (None, *_unpack(ctx.plan, *dpacked))


def _unpack(plan: _PackPlan, gw0, gb0, gwh, gbh, gwout, gbout) -> List[torch.Tensor]:
    """The sources' gradients (``_src_names`` order) from the packed ones."""
    if plan.w0_rows is not None:
        dk0 = gw0.index_select(0, plan.w0_rows) + 0.0
    else:
        dk0 = gw0[:plan.in_dim]
    grads = [dk0.T, gb0[0]]
    for i in range(gwh.shape[0]):
        grads += [gwh[i].T, gbh[i]]
    return grads + [gwout[:, 0:3].T, gbout[0, 0:3], gwout[:, 3:4].T, gbout[0, 3:4]]


def _gather_plan(state, num_layers: int, hidden_dim: int, d_pad: int,
                 row_perm: Optional[RowPerm]):
    """``(plan, sources)`` of ``pack_params``' gather, or ``None`` for a
    trunk with LoRA layers or a ``row_perm`` that is not a permutation of
    the first layer's input rows."""
    names = _src_names(num_layers)
    if not all(n in state for n in names):
        return None
    srcs = [state[n] for n in names]
    shapes = tuple(tuple(s.shape) for s in srcs)
    perm = None if row_perm is None else _host_perm(row_perm)
    if perm is not None and not np.array_equal(np.sort(perm), np.arange(shapes[0][1])):
        return None
    n_rows = shapes[0][1]
    if n_rows > d_pad:
        raise ValueError(f"pack_params: {n_rows} input rows exceed d_pad={d_pad}")
    for i in range(1, num_layers):
        if shapes[2 * i] != (hidden_dim, hidden_dim):
            raise ValueError(
                f"pack_params requires a uniform {hidden_dim}x{hidden_dim} trunk; "
                f"trunk.{i} has (in, out) shape {shapes[2 * i][::-1]} (skip connections "
                f"are not supported by the fused kernels)")
    return _pack_plan(shapes, hidden_dim, d_pad, perm, _canonical(srcs[0].device)), srcs


def _flat_of(dpacked: Packed) -> torch.Tensor:
    """The six packed gradients as one flat tensor: the buffer they are
    consecutive views of, as the kernels return them, else their
    concatenation."""
    base, off = dpacked[0]._base, dpacked[0].storage_offset()
    total = sum(d.numel() for d in dpacked)
    if (base is not None and base.dim() == 1 and base.is_contiguous()
            and base.storage_offset() == off and base.numel() == total):
        for d in dpacked:
            if d._base is not base or d.storage_offset() != off or not d.is_contiguous():
                break
            off += d.numel()
        else:
            return base
    return torch.cat([d.reshape(-1) for d in dpacked])


def packed_grads(state: Mapping[str, torch.Tensor], num_layers: int, hidden_dim: int,
                 d_pad: int, row_perm: Optional[RowPerm], dpacked: Packed,
                 out: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The gradients of a trunk without LoRA's parameters, by name, from the
    gradients of ``pack_params(state, ..., d_pad, row_perm)``'s six tensors:
    what autograd through the packing gives back for a cotangent of one,
    without the autograd engine (``_unpack``: views with the layer-by-layer
    packing's strides, and the gather of ``w0``'s rows).

    ``out``: a flat float32 buffer of the parameters' numel in
    ``_src_names`` order; the gradients are written there, each contiguous
    in its parameter's shape, by one gather from the packed gradients (and,
    with ``row_perm``, the +0.0 that ``_unpack`` adds to ``w0``'s), and the
    dict holds views of it: the same values, bit for bit."""
    found = _gather_plan(state, num_layers, hidden_dim, d_pad, row_perm)
    if found is None:
        raise ValueError("packed_grads: the trunk has LoRA layers (or row_perm is not a "
                         "permutation); take its gradients through the packing by autograd")
    plan, srcs = found
    names = _src_names(num_layers)
    if out is None:
        return dict(zip(names, _unpack(plan, *dpacked)))
    if out.dim() != 1 or not out.is_contiguous() or out.numel() != plan.bwd.numel():
        raise ValueError(f"packed_grads: out must be a contiguous flat buffer of "
                         f"{plan.bwd.numel()} elements; got {tuple(out.shape)}")
    torch.index_select(_flat_of(dpacked), 0, plan.bwd, out=out)
    if plan.w0_rows is not None:
        out[:srcs[0].numel()].add_(0.0)
    views, off = {}, 0
    for n, s in zip(names, srcs):
        views[n] = out[off:off + s.numel()].view(s.shape)
        off += s.numel()
    return views


def pack_params(
    state: Mapping[str, torch.Tensor],
    num_layers: int,
    hidden_dim: int,
    d_pad: int = D_PAD,
    row_perm: Optional[RowPerm] = None,
    lora_alpha: float = 16.0,
) -> Packed:
    """A NeRFMLP state dict -> the kernel's ``(w0 (d_pad,H), b0 (1,H),
    wh (L-1,H,H), bh (L-1,H), wout (H,128), bout (1,128))``, weights laid
    out (in, out). ``row_perm`` reorders the first layer's input rows
    (``pe_layout``'s sequence or ``pe_constants``' device tensor) before the
    zero padding. A trunk without LoRA is packed by one cached gather
    (``_GatherPack``; a ``row_perm`` that is no permutation of the input
    rows takes the layer-by-layer path); a LoRA trunk by ``lora_pack``
    (``render/lora_pack.py``: its kernel on a card, one launch per 32
    layers, its backward the VJP kernel; the layer-by-layer merge of
    ``_trunk_layer``, differentiated by autograd, on the CPU).
    A trunk with skip layers is refused."""
    from nerf_fewshot_tpu_torch.render.lora_pack import is_lora_trunk, lora_pack

    if is_lora_trunk(state, num_layers):
        device = next(iter(state.values())).device
        return lora_pack(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha,
                         plain=device.type == "cpu")
    found = _gather_plan(state, num_layers, hidden_dim, d_pad, row_perm)
    if found is not None:
        plan, srcs = found
        return _GatherPack.apply(plan, *srcs)
    return _pack_merged(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha)


def _pack_merged(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha) -> Packed:
    """``pack_params`` layer by layer: per-layer transposes (and LoRA
    merges), the row gather, stacks and concatenations."""
    k0, bias0 = _trunk_layer(state, 0, lora_alpha)
    if row_perm is not None:
        if not isinstance(row_perm, torch.Tensor):
            row_perm = torch.as_tensor(np.asarray(row_perm), dtype=torch.long)
        k0 = k0[row_perm.to(k0.device)]
    if k0.shape[0] > d_pad:
        raise ValueError(f"pack_params: {k0.shape[0]} input rows exceed d_pad={d_pad}")
    w0 = k0.new_zeros((d_pad, hidden_dim))
    w0[: k0.shape[0]] = k0
    b0 = bias0[None]

    whs, bhs = [], []
    for i in range(1, num_layers):
        k, b = _trunk_layer(state, i, lora_alpha)
        if k.shape != (hidden_dim, hidden_dim):
            raise ValueError(
                f"pack_params requires a uniform {hidden_dim}x{hidden_dim} trunk; "
                f"trunk.{i} has (in, out) shape {tuple(k.shape)} (skip connections are "
                f"not supported by the fused kernels)"
            )
        whs.append(k)
        bhs.append(b)
    wh = torch.stack(whs) if whs else k0.new_zeros((0, hidden_dim, hidden_dim))
    bh = torch.stack(bhs) if bhs else k0.new_zeros((0, hidden_dim))

    zeros = k0.new_zeros((hidden_dim, OUT_PAD - 4))
    wout = torch.cat([state["rgb_head.weight"].T, state["sigma_head.weight"].T, zeros], dim=1)
    bout = torch.cat(
        [state["rgb_head.bias"], state["sigma_head.bias"], k0.new_zeros(OUT_PAD - 4)]
    )[None]
    return tuple(t.contiguous() for t in (w0, b0, wh, bh, wout, bout))


def _phases_exact(raw: torch.Tensor, e2: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c + raw @ e2`` as per-column broadcast multiply-adds in fp32.
    Every nonzero of e2 is a power of two, so each product is exact and
    the phase is rounded once, as in the kernel."""
    acc = c
    for d in range(raw.shape[1]):
        acc = acc + raw[:, d:d + 1] * e2[d:d + 1, :]
    return acc


def _pe_input(raw, feats, e2, c, width: int) -> torch.Tensor:
    """The inline-PE kernels' input ``[raw | sin(phases) | feats | 0]``,
    zero-padded to ``width`` columns (``feats`` may be ``None``)."""
    blocks = [raw, torch.sin(_phases_exact(raw, e2, c))]
    if feats is not None:
        blocks.append(feats)
    x = torch.cat(blocks, dim=1)
    if x.shape[1] < width:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - x.shape[1]))], dim=1)
    return x


def _composite_terms(sigma: torch.Tensor, z: torch.Tensor, dnorm: torch.Tensor):
    """Compositing in log space, as the kernels compute it:
    ``ealpha = exp(-relu(sigma)*dists)``, ``om = ealpha + 1e-10``,
    ``T = exp(cumsum(log om) - log om)``, ``w = (1 - ealpha) * T``.
    Returns ``(ealpha, om, dists, T, w)``, each (R, S)."""
    R = sigma.shape[0]
    dists = torch.cat([z[:, 1:] - z[:, :-1], z.new_full((R, 1), 1e10)], dim=1) * dnorm
    ealpha = torch.exp(-torch.relu(sigma) * dists)
    om = ealpha + 1e-10
    logs = torch.log(om)
    trans = torch.exp(torch.cumsum(logs, dim=1) - logs)
    return ealpha, om, dists, trans, (1.0 - ealpha) * trans


def _composite(sigma: torch.Tensor, z: torch.Tensor, dnorm: torch.Tensor) -> torch.Tensor:
    """The compositing weights (R, S) of ``_composite_terms``."""
    return _composite_terms(sigma, z, dnorm)[-1]


# The precision routes of all five kernels, the JAX ``_dot``'s
# ``compute_dtype`` (``nerf_fewshot_tpu/render/kernels.py:63``), by the
# route number the C entries take:
# - ``float32``: the trunk products as 3xTF32 on the tensor cores;
# - ``bfloat16``: both operands of every product rounded to bf16 (to
#   nearest even), the products summed in fp32, one tensor-core pass;
# - ``highest``: every product as exact fp32 FFMAs on the CUDA cores.
# The PE phases, the compositing scans, the bias adds, the ReLU gates and
# the sigmoid are exact fp32 in every route.
ROUTES = {"float32": 0, "bfloat16": 1, "highest": 2}


def route_of(compute_dtype: str) -> int:
    """The C entries' route number of ``compute_dtype``; raises
    ``ValueError`` for a dtype the JAX kernels do not take."""
    if compute_dtype not in ROUTES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; expected one of "
                         f"{tuple(ROUTES)}")
    return ROUTES[compute_dtype]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and widened back."""
    return t.to(torch.bfloat16).to(t.dtype)


def _dot(a: torch.Tensor, b: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """The JAX ``_dot``: ``a @ b`` with both operands rounded to bf16 under
    ``bfloat16`` (a bf16 x bf16 product is exact in fp32, so only the order
    of the sums differs from JAX's), else in the operands' own precision
    (an fp32 matmul must run without TF32, PyTorch's default)."""
    if compute_dtype == "bfloat16":
        return _bf16(a) @ _bf16(b)
    return a @ b


def _trunk(x: torch.Tensor, packed: Packed, compute_dtype: str = "float32",
           head_dtype: Optional[str] = None):
    """The ReLU trunk and the packed head's 4 live columns: ``(out4 (N, 4),
    acts)``, ``acts[l]`` the input of layer ``l`` (``acts[0] = x``) and
    ``acts[-1]`` the last hidden layer. The products follow
    ``compute_dtype``, the head's ``head_dtype`` (default the same)."""
    w0, b0, wh, bh, wout, bout = packed
    acts = [x]
    h = torch.relu(_dot(x, w0, compute_dtype) + b0)
    for layer in range(wh.shape[0]):
        acts.append(h)
        h = torch.relu(_dot(h, wh[layer], compute_dtype) + bh[layer])
    acts.append(h)
    return _dot(h, wout[:, :4], head_dtype or compute_dtype) + bout[:, :4], acts


def fused_render_reference(x, z, dnorm, packed: Packed, white_bkgd: bool = False,
                           compute_dtype: str = "float32"):
    """Plain PyTorch version of kernel 4 (the body of ``_fwd_kernel``), on
    any device: the render from a pre-encoded (R*S, D) ``x``, its products
    rounded as ``compute_dtype``'s route rounds them (``_dot``). Returns rgb
    (R,3), depth (R,1), acc (R,1), weights (R,S)."""
    route_of(compute_dtype)
    R, S = z.shape
    out, _ = _trunk(x, packed, compute_dtype)
    rgb_s = torch.sigmoid(out[:, 0:3]).reshape(R, S, 3)
    weights = _composite(out[:, 3].reshape(R, S), z, dnorm)
    rgb = torch.sum(weights[..., None] * rgb_s, dim=1)
    acc = torch.sum(weights, dim=1, keepdim=True)
    if white_bkgd:
        rgb = rgb + (1.0 - acc)
    depth = torch.sum(weights * z, dim=1, keepdim=True)
    return rgb, depth, acc, weights


def fused_render_fwd_pe_reference(
    raw, feats, z, dnorm, e2, c, packed: Packed, white_bkgd: bool = False,
    compute_dtype: str = "float32", use_feats: bool = False,
):
    """Plain PyTorch version of kernel 2, on any device: the same inputs,
    the same arithmetic, sums in PyTorch's order. Returns rgb (R,3), depth
    (R,1), acc (R,1), weights (R,S)."""
    x = _pe_input(raw, feats if use_feats else None, e2, c, packed[0].shape[0])
    return fused_render_reference(x, z, dnorm, packed, white_bkgd, compute_dtype)


def _render_vjp(out, acts, z, dnorm, packed: Packed, g_rgb, g_depth, g_acc, g_weights,
                white_bkgd: bool, compute_dtype: str, need_dx: bool,
                dw_dtype: Optional[str] = None, head_dtype: Optional[str] = None):
    """The analytic VJP of the render from the trunk's ``(out, acts)``
    (``_trunk``), as the kernels compute it: ``g_acc -= sum g_rgb`` for a
    white background; ``dL/dw = rgb_s.g_rgb + g_depth*z + g_acc +
    g_weights``; the exclusive suffix sum ``s_after``, a scan from the last
    sample; ``d_alpha = dL/dw*T - s_after/om``; ``d_sigma`` gated by sigma >
    0; the sigmoid head; the ReLU-gated chain. The chain's products and dx
    follow ``compute_dtype``, the dW products ``dw_dtype`` and the head's
    two products ``head_dtype`` (default: ``compute_dtype``; the head's dW
    takes ``head_dtype`` when it is given, as the JAX ``head_mode="vpu"``
    does). Returns ``(dx or None, (dw0, db0, dwh, dbh, dwout, dbout))``."""
    w0, b0, wh, bh, wout, bout = packed
    dw_dtype = dw_dtype or compute_dtype
    R, S = z.shape
    N = R * S
    rgb_s = torch.sigmoid(out[:, 0:3]).reshape(R, S, 3)
    sigma = out[:, 3].reshape(R, S)
    ealpha, om, dists, trans, weights = _composite_terms(sigma, z, dnorm)
    if white_bkgd:
        g_acc = g_acc - torch.sum(g_rgb, dim=1, keepdim=True)
    dldw = torch.sum(rgb_s * g_rgb[:, None, :], dim=2) + g_depth * z + g_acc + g_weights
    q = dldw * weights
    incl_after = torch.flip(torch.cumsum(torch.flip(q, [1]), dim=1), [1])  # sum over t >= s
    s_after = torch.cat([incl_after[:, 1:], torch.zeros_like(q[:, :1])], dim=1)
    d_alpha = dldw * trans - s_after / om
    d_sigma = d_alpha * ealpha * dists * (sigma > 0.0).to(z.dtype)
    d_pre_rgb = weights[..., None] * g_rgb[:, None, :] * rgb_s * (1.0 - rgb_s)
    g_out = torch.cat([d_pre_rgb.reshape(N, 3), d_sigma.reshape(N, 1)], dim=1)

    dwout = torch.zeros_like(wout)
    dwout[:, :4] = _dot(acts[-1].T, g_out, head_dtype or dw_dtype)
    dbout = torch.zeros_like(bout)
    dbout[:, :4] = torch.sum(g_out, dim=0, keepdim=True)
    g_h = _dot(g_out, wout[:, :4].T, head_dtype or compute_dtype)
    dwh, dbh = torch.zeros_like(wh), torch.zeros_like(bh)
    for layer in range(wh.shape[0] - 1, -1, -1):
        g_h = g_h * (acts[layer + 2] > 0.0).to(z.dtype)
        dwh[layer] = _dot(acts[layer + 1].T, g_h, dw_dtype)
        dbh[layer] = torch.sum(g_h, dim=0)
        g_h = _dot(g_h, wh[layer].T, compute_dtype)
    g_h = g_h * (acts[1] > 0.0).to(z.dtype)
    dw0 = _dot(acts[0].T, g_h, dw_dtype)
    db0 = torch.sum(g_h, dim=0, keepdim=True)
    dx = _dot(g_h, w0.T, compute_dtype) if need_dx else None
    return dx, (dw0, db0, dwh, dbh, dwout, dbout)


def fused_render_bwd_reference(
    x, z, dnorm, packed: Packed, g_rgb, g_depth, g_acc, g_weights, white_bkgd: bool = False,
    compute_dtype: str = "float32", need_dx: bool = True,
):
    """Plain PyTorch version of kernel 3 (the body of ``_bwd_kernel``), on
    any device, written out analytically as the kernel computes it: the
    forward recomputed from ``x``, then ``_render_vjp``, every product
    rounded as ``compute_dtype``'s route rounds it (``_dot``). Returns
    ``(dx (R*S, D) or None, (dw0, db0, dwh, dbh, dwout, dbout))``."""
    route_of(compute_dtype)
    out, acts = _trunk(x, packed, compute_dtype)
    return _render_vjp(out, acts, z, dnorm, packed, g_rgb, g_depth, g_acc, g_weights,
                       white_bkgd, compute_dtype, need_dx)


def _lib_fn(source: str, name: str, argtypes):
    """Build (once) and load ``csrc/<source>.cu``; the C function ``name``
    with its argtypes set."""
    lib, _ = cuda_build.load(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.nerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.nerf_cuda_error_string(err).decode()})")


# The kernels' scratch (the backward kernels' activations and cotangents;
# the render forward's weight halves and head outputs): one buffer per
# device and source, grown to the largest call seen and reused by every
# later call (calls are ordered on the current stream, so reuse is safe
# there).
_SCRATCH: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def _scratch(lib, device: torch.device, R: int, S: int, D: int, H: int, L1: int,
             source: str = "train_pe") -> torch.Tensor:
    """The scratch ``csrc/<source>.cu`` needs for R x S points of a D-wide
    input through an L1+1-layer, H-wide trunk; raises ``MemoryError``
    naming the shape and the bytes when the card cannot hold it."""
    size = getattr(lib, "nerf_fwd_scratch_floats" if source == "fwd_pe"
                   else "nerf_train_scratch_floats")
    if size.argtypes is None:
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_ulonglong
    n_floats = size(R, S, D, H, L1)
    key = (device, source)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n_floats:
        _SCRATCH.pop(key, None)
        try:
            buf = torch.empty(n_floats, dtype=torch.float32, device=device)
        except torch.OutOfMemoryError:
            raise MemoryError(
                f"{source}: the scratch of {R} rays x {S} samples through a {L1 + 1} x {H} "
                f"trunk from a {D}-wide input needs {4 * n_floats / 2 ** 30:.2f} GiB, more "
                f"than {device} can allocate") from None
        _SCRATCH[key] = buf
    return buf


def scratch_buffers() -> List[torch.Tensor]:
    """The kernels' scratch buffers as they are now. A CUDA graph that
    captured a kernel call holds the scratch it was given: it keeps these
    alive, as a later, larger call replaces the cached one."""
    return list(_SCRATCH.values())


def _split_grads(flat: torch.Tensor, packed: Packed) -> Packed:
    """The backward kernels' flat gradient buffer as views shaped like
    ``packed``."""
    out, off = [], 0
    for p in packed:
        out.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    return tuple(out)


def _expect(t: torch.Tensor, name: str, shape, device: torch.device,
            caller: str = "fused_render_fwd_pe") -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{caller}: {name} must be a contiguous float32 tensor on "
            f"{device}; got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{caller}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_points(R: int, S: int, caller: str) -> None:
    """Raise unless R >= 1 rays of S >= 1 samples, R*S within MAX_POINTS."""
    if R < 1 or S < 1 or R * S > MAX_POINTS:
        raise ValueError(f"{caller}: need R >= 1, S >= 1 and R*S <= {MAX_POINTS}; "
                         f"got {R} x {S}")


def _check_width(H: int, caller: str) -> None:
    """Raise unless the trunk width is one the kernels take (the JAX
    kernels' ``H % 128 == 0``)."""
    if H <= 0 or H % H_ALIGN:
        raise ValueError(f"{caller}: trunk width {H} is not a multiple of {H_ALIGN}")


def _check_card(device: torch.device, caller: str) -> None:
    """Raise unless ``device`` is a CUDA device of capability (9, 0)."""
    if device.type != "cuda":
        raise ValueError(f"{caller}: no kernel for device {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{caller}: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}"
        )


def fused_render_fwd_pe(
    raw, feats, z, dnorm, e2, c, packed: Packed, white_bkgd: bool = False,
    compute_dtype: str = "float32", use_feats: bool = False,
):
    """Forward-only inline-PE render: ``(rgb (R,3), depth (R,1), acc (R,1),
    weights (R,S))``.

    ``raw`` is the thin (R*S, n_raw) [pts | dirs?] block, ``feats`` the
    (R*S, Fd) per-point features (``None`` unless ``use_feats``),
    ``packed`` the ``pack_params(row_perm=pe_layout(...)[0])`` weights.
    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count one in ``fused_render_fwd_pe.launches``; ``compute_dtype`` picks
    the precision route (``ROUTES``).
    """
    route = route_of(compute_dtype)
    if raw.device.type == "cpu":
        return fused_render_fwd_pe_reference(
            raw, feats, z, dnorm, e2, c, packed, white_bkgd, compute_dtype, use_feats
        )
    device = raw.device
    _check_card(device, "fused_render_fwd_pe")
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    n_raw = raw.shape[1]
    n_phase = e2.shape[1]
    D, H = w0.shape
    L1 = wh.shape[0]
    Fd = feats.shape[1] if use_feats else 0
    _check_width(H, "fused_render_fwd_pe")
    if D % PE_ALIGN or n_raw + n_phase + Fd > D:
        raise ValueError(
            f"fused_render_fwd_pe: input width {n_raw}+{n_phase}+{Fd} needs "
            f"d_pad >= it and a multiple of {PE_ALIGN}; got {D}"
        )
    _check_points(R, S, "fused_render_fwd_pe")
    _expect(raw, "raw", (R * S, n_raw), device)
    if use_feats:
        _expect(feats, "feats", (R * S, Fd), device)
    _expect(z, "z", (R, S), device)
    _expect(dnorm, "dnorm", (R, 1), device)
    _expect(e2, "e2", (n_raw, n_phase), device)
    _expect(c, "c", (1, n_phase), device)
    _expect(w0, "w0", (D, H), device)
    _expect(b0, "b0", (1, H), device)
    _expect(wh, "wh", (L1, H, H), device)
    _expect(bh, "bh", (L1, H), device)
    _expect(wout, "wout", (H, OUT_PAD), device)
    _expect(bout, "bout", (1, OUT_PAD), device)

    rgb = torch.empty((R, 3), dtype=torch.float32, device=device)
    depth = torch.empty((R, 1), dtype=torch.float32, device=device)
    acc = torch.empty((R, 1), dtype=torch.float32, device=device)
    weights = torch.empty((R, S), dtype=torch.float32, device=device)
    lib, fn = _lib_fn("fwd_pe", "nerf_fwd_pe", FWD_PE_ARGTYPES)
    scratch = _scratch(lib, device, R, S, D, H, L1, source="fwd_pe")
    feats_ptr = feats.data_ptr() if use_feats else None
    ptrs = [t.data_ptr() for t in (z, dnorm, e2, c, w0, b0, wh, bh, wout, bout,
                                   rgb, depth, acc, weights, scratch)]
    err = fn(raw.data_ptr(), feats_ptr, *ptrs, R, S, n_raw, n_phase, Fd, D, H, L1,
             int(white_bkgd), route, device.index, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, lib, "fwd_pe")
    fused_render_fwd_pe.launches += 1
    return rgb, depth, acc, weights


fused_render_fwd_pe.launches = 0


def _check_x_render(x, z, dnorm, packed: Packed, caller: str):
    """The wrappers' checks of a render from a pre-encoded ``x`` on a card:
    shapes, widths, dtype and contiguity. Returns ``(R, S, D, H, L1)``."""
    device = x.device
    _check_card(device, caller)
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    D, H = w0.shape
    L1 = wh.shape[0]
    _check_width(H, caller)
    if D % D_PAD:
        raise ValueError(f"{caller}: x width {D} must be a multiple of {D_PAD}")
    _check_points(R, S, caller)
    for t, name, shape in ((x, "x", (R * S, D)), (z, "z", (R, S)), (dnorm, "dnorm", (R, 1)),
                           (w0, "w0", (D, H)), (b0, "b0", (1, H)), (wh, "wh", (L1, H, H)),
                           (bh, "bh", (L1, H)), (wout, "wout", (H, OUT_PAD)),
                           (bout, "bout", (1, OUT_PAD))):
        _expect(t, name, shape, device, caller)
    return R, S, D, H, L1


def fused_render_fwd(x, z, dnorm, packed: Packed, white_bkgd: bool = False,
                     compute_dtype: str = "float32"):
    """The render of kernel 4 from a pre-encoded (R*S, D) ``x``
    (``encode_points``, D a multiple of 128) with ``pack_params(d_pad=D)`` weights:
    ``(rgb (R,3), depth (R,1), acc (R,1), weights (R,S))``. CPU tensors run
    ``fused_render_reference``; CUDA tensors launch ``nerf_fwd_x`` and count
    one in ``fused_render_fwd.launches``."""
    route = route_of(compute_dtype)
    if x.device.type == "cpu":
        return fused_render_reference(x, z, dnorm, packed, white_bkgd, compute_dtype)
    R, S, D, H, L1 = _check_x_render(x, z, dnorm, packed, "fused_render_fwd")
    device = x.device
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    lib, fn = _lib_fn("fwd_pe", "nerf_fwd_x", FWD_X_ARGTYPES)
    scratch = _scratch(lib, device, R, S, D, H, L1, source="fwd_pe")
    err = fn(*(t.data_ptr() for t in (x, z, dnorm, *packed, *outs, scratch)), R, S, D, H, L1,
             int(white_bkgd), route, device.index, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, lib, "fwd_x")
    fused_render_fwd.launches += 1
    return tuple(outs)


fused_render_fwd.launches = 0


def fused_render_bwd(x, z, dnorm, packed: Packed, g_rgb, g_depth, g_acc, g_weights,
                     white_bkgd: bool = False, compute_dtype: str = "float32",
                     need_dx: bool = True):
    """The VJP of ``fused_render_fwd`` (kernel 3): from the cotangents
    ``g_rgb (R,3), g_depth (R,1), g_acc (R,1), g_weights (R,S)`` of its four
    outputs, ``(dx (R*S, D) or None, (dw0, db0, dwh, dbh, dwout, dbout))``;
    ``dx`` only with ``need_dx``. CPU tensors run
    ``fused_render_bwd_reference``; CUDA tensors launch ``nerf_render_bwd``
    and count one in ``fused_render_bwd.launches``."""
    route = route_of(compute_dtype)
    cot = tuple(g.contiguous() for g in (g_rgb, g_depth, g_acc, g_weights))
    if x.device.type == "cpu":
        return fused_render_bwd_reference(x, z, dnorm, packed, *cot, white_bkgd, compute_dtype,
                                          need_dx)
    caller = "fused_render_bwd"
    R, S, D, H, L1 = _check_x_render(x, z, dnorm, packed, caller)
    device = x.device
    for t, name, shape in zip(cot, ("g_rgb", "g_depth", "g_acc", "g_weights"),
                              ((R, 3), (R, 1), (R, 1), (R, S))):
        _expect(t, name, shape, device, caller)
    lib, fn = _lib_fn("train_pe", "nerf_render_bwd", RENDER_BWD_ARGTYPES)
    scratch = _scratch(lib, device, R, S, D, H, L1)
    grads = torch.empty(sum(p.numel() for p in packed), dtype=torch.float32, device=device)
    dx = torch.empty((R * S, D), dtype=torch.float32, device=device) if need_dx else None
    ptrs = [t.data_ptr() for t in (x, z, dnorm, *packed, *cot)]
    err = fn(*ptrs, None if dx is None else dx.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
             R, S, D, H, L1, int(white_bkgd), route, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, lib, "render_bwd")
    fused_render_bwd.launches += 1
    return dx, _split_grads(grads, packed)


fused_render_bwd.launches = 0


class _FusedRender(torch.autograd.Function):
    """The differentiable render of ``x`` and the six packed tensors:
    forward ``fused_render_fwd`` (kernel 4); backward ``fused_render_bwd``
    (kernel 3), which recomputes the forward from the saved inputs, as the
    JAX rule does. ``z`` and ``dnorm`` get no gradient (the JAX rule returns
    zero cotangents for them), and ``dx`` is computed only when ``x``
    requires it."""

    @staticmethod
    def forward(ctx, x, z, dnorm, opts, *packed):
        ctx.save_for_backward(x, z, dnorm, *packed)
        ctx.opts = opts
        return fused_render_fwd(x, z, dnorm, packed, **opts)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_weights):
        x, z, dnorm, *packed = ctx.saved_tensors
        dx, dpacked = fused_render_bwd(x, z, dnorm, tuple(packed), g_rgb, g_depth, g_acc,
                                       g_weights, need_dx=ctx.needs_input_grad[0], **ctx.opts)
        return (dx, None, None, None, *dpacked)


def fused_render(x, z, dnorm, packed: Packed, white_bkgd: bool = False,
                 compute_dtype: str = "float32"):
    """Differentiable fused MLP + alpha-composite render of a pre-encoded
    (R*S, D) ``x``: ``(rgb (R,3), depth (R,1), acc (R,1), weights (R,S))``,
    differentiable in ``x`` and the packed weights (``pack_params`` is
    differentiable, so gradients reach the ``NeRFMLP`` parameters)."""
    route_of(compute_dtype)
    opts = dict(white_bkgd=white_bkgd, compute_dtype=compute_dtype)
    return _FusedRender.apply(x, z.contiguous(), dnorm.contiguous(), opts, *packed)
