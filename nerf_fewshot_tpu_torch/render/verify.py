"""The card's numerics gate: the training kernel's gradients against plain
autograd on identical inputs (counterpart of
``nerf_fewshot_tpu/render/verify.py``).

Kernel 1 (``csrc/train_pe.cu``, inline PE) computes the loss and every
gradient of a training step itself, with 3xTF32 trunk products and its own
order of sums; a wrong precision or a broken backward shows only where the
kernel runs, on the card. On the CPU ``fused_train_loss_grad`` runs its plain
version, which would compare autograd with itself, so the gate raises there.

The shapes are the JAX gate's: 256 rays x 16 samples, a 3x128 trunk, the
real configs' pos_freq 10 / dir_freq 4 (a lower frequency hides phase
errors), rays from (0, 0, 4) looking into the scene volume, targets and
directions from ``np.random.default_rng(0)``, the ``NeRFMLP`` from
``torch.Generator().manual_seed(0)``. The plain side runs with
``torch.backends.cuda.matmul.allow_tf32`` cleared (cuBLAS would otherwise
keep ~3 digits), restored afterwards.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerf_fewshot_tpu_torch.render.train_kernel import fused_train_loss_grad

# Relative gradient error bound, kernel vs plain autograd (the JAX gate's):
# at sigma_bias 5.0 the transmittances reach the 1e-10 floor, where the
# backward divides by them, and two correct fp32 routes part by ~1e-3.
GRAD_REL_TOL = 2e-2


def kernel_gradient_check(tol: float = GRAD_REL_TOL, sigma_bias: float = 0.1) -> Dict[str, Any]:
    """Kernel 1 and plain autograd on identical inputs on the card.

    Returns ``{"ok", "grad_rel_err", "loss_rel_err", "backend"}``. ``ok``
    needs a live model (a plain gradient norm above 1e-6: a dead sigma head
    has zero gradients on both sides), the gradients as one vector within
    ``tol`` (relative to the plain norm) and the losses within rel 1e-4.
    ``sigma_bias`` sets the regime: 0.1 the live start, 5.0 saturated alphas
    with transmittances at the 1e-10 floor. Raises ``RuntimeError`` without
    a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kernel_gradient_check is a CUDA-only gate: without a card "
            "fused_train_loss_grad runs its plain version, and the comparison "
            "would hold autograd against itself")
    device = torch.device("cuda", 0)
    R, S, H, L, PF, DF = 256, 16, 128, 3, 10, 4
    model = NeRFMLP(PF, DF, use_viewdirs=True, hidden_dim=H, num_layers=L,
                    sigma_bias_init=sigma_bias,
                    generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    ro = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (R, 3)).copy()
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0  # rays look into the scene volume
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ro, rd, tgt = (torch.as_tensor(a, device=device) for a in (ro, d, tgt))
    mask = torch.ones(R, device=device)
    settings = RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False)

    loss_k, grads_k = fused_train_loss_grad(model, ro, rd, tgt, mask, settings, PF, DF, L, H)
    names = [n for n, _ in model.named_parameters()]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = render_rays(model, ro, rd, settings)
        loss_x = torch.mean((out.rgb - tgt) ** 2)
        grads_x = torch.autograd.grad(loss_x, [p for _, p in model.named_parameters()])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    fk = torch.cat([grads_k[n].reshape(-1) for n in names]).double()
    fx = torch.cat([g.reshape(-1) for g in grads_x]).double()
    plain_norm = float(torch.linalg.norm(fx))
    live = plain_norm > 1e-6
    grad_rel = float(torch.linalg.norm(fk - fx)) / plain_norm if live else float("inf")
    loss_rel = abs(float(loss_k) - float(loss_x)) / max(abs(float(loss_x)), 1e-12)
    return {
        "ok": bool(live and grad_rel < tol and loss_rel < 1e-4),
        "grad_rel_err": grad_rel,
        "loss_rel_err": loss_rel,
        "backend": "cuda",
    }
