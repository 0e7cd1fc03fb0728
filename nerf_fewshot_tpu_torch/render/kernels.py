"""The forward inline-PE render kernel and its host glue (counterpart of
``nerf_fewshot_tpu/render/kernels.py``: ``pe_layout``, ``_raw_block``,
``pack_params`` and ``fused_render_fwd_pe`` around ``_fwd_pe_kernel``).

``fused_render_fwd_pe`` launches the CUDA kernel of ``csrc/fwd_pe.cu`` on
CUDA tensors and runs ``fused_render_fwd_pe_reference``, the plain PyTorch
version of the same arithmetic, on CPU tensors. There is no other route:
a CUDA tensor on a card that is not sm_90 raises.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from nerf_fewshot_tpu_torch.render import cuda_build

D_PAD = 128  # input-feature rows of w0 are padded to a multiple of this
OUT_PAD = 128  # packed head columns: [r, g, b, sigma, 0...]
KERNEL_WIDTHS = (128, 256)  # trunk widths the CUDA kernel is built for
MAX_SAMPLES = 1024  # per-ray sigma/rgb scratch of the kernel lives in smem
# csrc/fwd_pe.cu:nerf_fwd_pe(16 pointers, 10 ints, stream)
FWD_PE_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

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


def _raw_block(pts: torch.Tensor, rays_d: torch.Tensor, use_viewdirs: bool) -> torch.Tensor:
    """(R, S, 3) points [+ per-sample ray dirs] -> the thin (R*S, n_raw)
    block the inline-PE kernel reads."""
    R, S, _ = pts.shape
    blocks = [pts.reshape(-1, 3)]
    if use_viewdirs:
        blocks.append(rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3))
    return torch.cat(blocks, dim=-1).contiguous()


def pack_params(
    state: Mapping[str, torch.Tensor],
    num_layers: int,
    hidden_dim: int,
    d_pad: int = D_PAD,
    row_perm: Optional[Sequence[int]] = None,
) -> Packed:
    """A NeRFMLP state dict -> the kernel's ``(w0 (d_pad,H), b0 (1,H),
    wh (L-1,H,H), bh (L-1,H), wout (H,128), bout (1,128))``, weights laid
    out (in, out). ``row_perm`` reorders the first layer's input rows
    (``pe_layout``) before the zero padding."""
    k0 = state["trunk.0.weight"].T
    if row_perm is not None:
        k0 = k0[torch.as_tensor(np.asarray(row_perm), dtype=torch.long, device=k0.device)]
    if k0.shape[0] > d_pad:
        raise ValueError(f"pack_params: {k0.shape[0]} input rows exceed d_pad={d_pad}")
    w0 = k0.new_zeros((d_pad, hidden_dim))
    w0[: k0.shape[0]] = k0
    b0 = state["trunk.0.bias"][None]

    whs, bhs = [], []
    for i in range(1, num_layers):
        k = state[f"trunk.{i}.weight"].T
        if k.shape != (hidden_dim, hidden_dim):
            raise ValueError(
                f"pack_params requires a uniform {hidden_dim}x{hidden_dim} trunk; "
                f"trunk.{i} has (in, out) shape {tuple(k.shape)}"
            )
        whs.append(k)
        bhs.append(state[f"trunk.{i}.bias"])
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


def _composite(sigma: torch.Tensor, z: torch.Tensor, dnorm: torch.Tensor) -> torch.Tensor:
    """Compositing weights in log space, as the kernel computes them:
    ``om = exp(-relu(sigma)*dists) + 1e-10``, ``T = exp(cumsum(log om) -
    log om)``, ``w = (1 - exp(-relu(sigma)*dists)) * T``."""
    R = sigma.shape[0]
    dists = torch.cat([z[:, 1:] - z[:, :-1], z.new_full((R, 1), 1e10)], dim=1) * dnorm
    ealpha = torch.exp(-torch.relu(sigma) * dists)
    logs = torch.log(ealpha + 1e-10)
    trans = torch.exp(torch.cumsum(logs, dim=1) - logs)
    return (1.0 - ealpha) * trans


def _check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet; 'float32' and "
            "'highest' both run exact fp32"
        )
    if compute_dtype not in ("float32", "highest"):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def fused_render_fwd_pe_reference(
    raw, feats, z, dnorm, e2, c, packed: Packed, white_bkgd: bool = False,
    compute_dtype: str = "float32", use_feats: bool = False,
):
    """Plain PyTorch version of the kernel, on any device: the same
    inputs, the same arithmetic, sums in PyTorch's order. Matmuls must
    run in fp32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
    default). Returns rgb (R,3), depth (R,1), acc (R,1), weights (R,S)."""
    _check_compute_dtype(compute_dtype)
    w0, b0, wh, bh, wout, bout = packed
    R, S = z.shape
    x = _pe_input(raw, feats if use_feats else None, e2, c, w0.shape[0])
    h = torch.relu(x @ w0 + b0)
    for layer in range(wh.shape[0]):
        h = torch.relu(h @ wh[layer] + bh[layer])
    out = h @ wout[:, :4] + bout[:, :4]
    rgb_s = torch.sigmoid(out[:, 0:3]).reshape(R, S, 3)
    weights = _composite(out[:, 3].reshape(R, S), z, dnorm)
    rgb = torch.sum(weights[..., None] * rgb_s, dim=1)
    acc = torch.sum(weights, dim=1, keepdim=True)
    if white_bkgd:
        rgb = rgb + (1.0 - acc)
    depth = torch.sum(weights * z, dim=1, keepdim=True)
    return rgb, depth, acc, weights


def _kernel_fn():
    lib, _ = cuda_build.load("fwd_pe")
    fn = lib.nerf_fwd_pe
    if fn.argtypes is None:
        fn.argtypes = FWD_PE_ARGTYPES
        fn.restype = ctypes.c_int
        lib.nerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


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
    if D % 16 or D > 256 or n_raw + n_phase + Fd > D:
        raise ValueError(
            f"fused_render_fwd_pe: input width {n_raw}+{n_phase}+{Fd} needs "
            f"d_pad >= it, a multiple of 16 and <= 256; got {D}"
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
    lib, fn = _kernel_fn()
    feats_ptr = feats.data_ptr() if use_feats else None
    ptrs = [t.data_ptr() for t in (z, dnorm, e2, c, w0, b0, wh, bh, wout, bout,
                                   rgb, depth, acc, weights)]
    err = fn(raw.data_ptr(), feats_ptr, *ptrs, R, S, n_raw, n_phase, Fd, D, H, L1,
             int(white_bkgd), device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fwd_pe kernel launch failed: CUDA error {err} "
            f"({lib.nerf_cuda_error_string(err).decode()})"
        )
    fused_render_fwd_pe.launches += 1
    return rgb, depth, acc, weights


fused_render_fwd_pe.launches = 0
