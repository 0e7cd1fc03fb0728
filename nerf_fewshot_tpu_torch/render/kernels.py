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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from nerf_fewshot_tpu_torch.render import cuda_build

# Input widths. The pre-encoded x of kernels 3, 4 and 5 is any multiple of
# D_PAD (``encode_points`` pads to one, as the JAX kernels do), which keeps
# the 64-column dx tiles of kernel 3 whole; the inline-PE input of kernels 1
# and 2 is padded to a multiple of PE_ALIGN (``pe_width``). All five take
# up to MAX_INPUT_WIDTH columns (csrc kMaxD in both sources): 7 x 128, the
# script recipes' 831 / 858 live columns (D 832 / 864 inline, 896 encoded).
D_PAD = 128
PE_ALIGN = 16
MAX_INPUT_WIDTH = 896
OUT_PAD = 128  # packed head columns: [r, g, b, sigma, 0...]
KERNEL_WIDTHS = (128, 256)  # trunk widths the CUDA kernel is built for
MAX_SAMPLES = 1024  # per-ray sigma/rgb scratch of the kernel lives in smem
# csrc/fwd_pe.cu:nerf_fwd_pe(17 pointers (the last the scratch), 10 ints, stream)
FWD_PE_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# csrc/fwd_pe.cu:nerf_fwd_x(14 pointers (the last the scratch), 7 ints, stream)
FWD_X_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# csrc/train_pe.cu:nerf_render_bwd(16 pointers, 7 ints, stream)
RENDER_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
MAX_LAYERS = 15  # trunk layers the backward kernels take (train_pe.cu kMaxJobs - 1)

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


def pack_params(
    state: Mapping[str, torch.Tensor],
    num_layers: int,
    hidden_dim: int,
    d_pad: int = D_PAD,
    row_perm: Optional[Sequence[int]] = None,
    lora_alpha: float = 16.0,
) -> Packed:
    """A NeRFMLP state dict -> the kernel's ``(w0 (d_pad,H), b0 (1,H),
    wh (L-1,H,H), bh (L-1,H), wout (H,128), bout (1,128))``, weights laid
    out (in, out). ``row_perm`` reorders the first layer's input rows
    (``pe_layout``) before the zero padding. LoRA trunk layers are merged
    (``_trunk_layer``); gradients reach ``lora_a`` and ``lora_b`` through
    the merge by autograd. A trunk with skip layers is refused."""
    k0, bias0 = _trunk_layer(state, 0, lora_alpha)
    if row_perm is not None:
        k0 = k0[torch.as_tensor(np.asarray(row_perm), dtype=torch.long, device=k0.device)]
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


def _trunk(x: torch.Tensor, packed: Packed):
    """The ReLU trunk and the packed head's 4 live columns: ``(out4 (N, 4),
    acts)``, ``acts[l]`` the input of layer ``l`` (``acts[0] = x``) and
    ``acts[-1]`` the last hidden layer."""
    w0, b0, wh, bh, wout, bout = packed
    acts = [x]
    h = torch.relu(x @ w0 + b0)
    for layer in range(wh.shape[0]):
        acts.append(h)
        h = torch.relu(h @ wh[layer] + bh[layer])
    acts.append(h)
    return h @ wout[:, :4] + bout[:, :4], acts


def _check_compute_dtype(compute_dtype: str) -> None:
    """``float32`` and ``highest`` run the same kernels, all five with their
    trunk products as 3xTF32 on the tensor cores (``csrc/fwd_pe.cu`` for the
    render forward, kernels 2 and 4; ``csrc/train_pe.cu`` for the objective
    and the render VJP, kernels 1, 5 and 3), the PE phases, the head and the
    compositing scans in exact fp32. ``bfloat16`` is not ported."""
    if compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet; 'float32' and "
            "'highest' both run the fp32 kernels (trunk products of the "
            "objective and the render VJP as 3xTF32)"
        )
    if compute_dtype not in ("float32", "highest"):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def fused_render_reference(x, z, dnorm, packed: Packed, white_bkgd: bool = False,
                           compute_dtype: str = "float32"):
    """Plain PyTorch version of kernel 4 (the body of ``_fwd_kernel``), on
    any device: the render from a pre-encoded (R*S, D) ``x``. Matmuls must
    run in fp32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
    default). Returns rgb (R,3), depth (R,1), acc (R,1), weights (R,S)."""
    _check_compute_dtype(compute_dtype)
    R, S = z.shape
    out, _ = _trunk(x, packed)
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


def fused_render_bwd_reference(
    x, z, dnorm, packed: Packed, g_rgb, g_depth, g_acc, g_weights, white_bkgd: bool = False,
    compute_dtype: str = "float32", need_dx: bool = True,
):
    """Plain PyTorch version of kernel 3 (the body of ``_bwd_kernel``), on
    any device, written out analytically as the kernel computes it: the
    forward recomputed from ``x``; ``g_acc -= sum g_rgb`` for a white
    background; ``dL/dw = rgb_s.g_rgb + g_depth*z + g_acc + g_weights``;
    the exclusive suffix sum ``s_after``, a scan from the last sample;
    ``d_alpha = dL/dw*T - s_after/om``; ``d_sigma`` gated by sigma > 0; the
    sigmoid head; the ReLU-gated chain. Returns ``(dx (R*S, D) or None,
    (dw0, db0, dwh, dbh, dwout, dbout))``."""
    _check_compute_dtype(compute_dtype)
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    N = R * S
    out, acts = _trunk(x, packed)
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
    dwout[:, :4] = acts[-1].T @ g_out
    dbout = torch.zeros_like(bout)
    dbout[:, :4] = torch.sum(g_out, dim=0, keepdim=True)
    g_h = g_out @ wout[:, :4].T
    dwh, dbh = torch.zeros_like(wh), torch.zeros_like(bh)
    for layer in range(wh.shape[0] - 1, -1, -1):
        g_h = g_h * (acts[layer + 2] > 0.0).to(z.dtype)
        dwh[layer] = acts[layer + 1].T @ g_h
        dbh[layer] = torch.sum(g_h, dim=0)
        g_h = g_h @ wh[layer].T
    g_h = g_h * (acts[1] > 0.0).to(z.dtype)
    dw0 = acts[0].T @ g_h
    db0 = torch.sum(g_h, dim=0, keepdim=True)
    dx = g_h @ w0.T if need_dx else None
    return dx, (dw0, db0, dwh, dbh, dwout, dbout)


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
    input through an L1+1-layer, H-wide trunk."""
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
        buf = torch.empty(n_floats, dtype=torch.float32, device=device)
        _SCRATCH[key] = buf
    return buf


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
    count one in ``fused_render_fwd_pe.launches``.
    """
    _check_compute_dtype(compute_dtype)
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
    if H not in KERNEL_WIDTHS:
        raise ValueError(f"fused_render_fwd_pe: trunk width {H} not in {KERNEL_WIDTHS}")
    if D % PE_ALIGN or D > MAX_INPUT_WIDTH or n_raw + n_phase + Fd > D:
        raise ValueError(
            f"fused_render_fwd_pe: input width {n_raw}+{n_phase}+{Fd} needs "
            f"d_pad >= it, a multiple of {PE_ALIGN} and <= {MAX_INPUT_WIDTH}; got {D}"
        )
    if not (1 <= S <= MAX_SAMPLES) or R < 1:
        raise ValueError(f"fused_render_fwd_pe: need R >= 1 and 1 <= S <= {MAX_SAMPLES}; got {R}, {S}")
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
             int(white_bkgd), device.index, torch.cuda.current_stream(device).cuda_stream)
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
    if H not in KERNEL_WIDTHS:
        raise ValueError(f"{caller}: trunk width {H} not in {KERNEL_WIDTHS}")
    if D % D_PAD or D > MAX_INPUT_WIDTH:
        raise ValueError(f"{caller}: x width {D} must be a multiple of {D_PAD} "
                         f"and <= {MAX_INPUT_WIDTH}")
    if not (1 <= S <= MAX_SAMPLES) or R < 1:
        raise ValueError(f"{caller}: need R >= 1 and 1 <= S <= {MAX_SAMPLES}; got {R}, {S}")
    if L1 + 1 > MAX_LAYERS:
        raise ValueError(f"{caller}: at most {MAX_LAYERS} trunk layers; got {L1 + 1}")
    for t, name, shape in ((x, "x", (R * S, D)), (z, "z", (R, S)), (dnorm, "dnorm", (R, 1)),
                           (w0, "w0", (D, H)), (b0, "b0", (1, H)), (wh, "wh", (L1, H, H)),
                           (bh, "bh", (L1, H)), (wout, "wout", (H, OUT_PAD)),
                           (bout, "bout", (1, OUT_PAD))):
        _expect(t, name, shape, device, caller)
    return R, S, D, H, L1


def fused_render_fwd(x, z, dnorm, packed: Packed, white_bkgd: bool = False,
                     compute_dtype: str = "float32"):
    """The render of kernel 4 from a pre-encoded (R*S, D) ``x``
    (``encode_points``, D a multiple of 128 up to 896) with ``pack_params(d_pad=D)`` weights:
    ``(rgb (R,3), depth (R,1), acc (R,1), weights (R,S))``. CPU tensors run
    ``fused_render_reference``; CUDA tensors launch ``nerf_fwd_x`` and count
    one in ``fused_render_fwd.launches``."""
    _check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return fused_render_reference(x, z, dnorm, packed, white_bkgd, compute_dtype)
    R, S, D, H, L1 = _check_x_render(x, z, dnorm, packed, "fused_render_fwd")
    device = x.device
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    lib, fn = _lib_fn("fwd_pe", "nerf_fwd_x", FWD_X_ARGTYPES)
    scratch = _scratch(lib, device, R, S, D, H, L1, source="fwd_pe")
    err = fn(*(t.data_ptr() for t in (x, z, dnorm, *packed, *outs, scratch)), R, S, D, H, L1,
             int(white_bkgd), device.index, torch.cuda.current_stream(device).cuda_stream)
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
    _check_compute_dtype(compute_dtype)
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
             R, S, D, H, L1, int(white_bkgd), device.index,
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
    _check_compute_dtype(compute_dtype)
    opts = dict(white_bkgd=white_bkgd, compute_dtype=compute_dtype)
    return _FusedRender.apply(x, z.contiguous(), dnorm.contiguous(), opts, *packed)
