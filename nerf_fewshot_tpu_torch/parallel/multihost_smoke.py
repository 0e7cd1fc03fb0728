"""Multi-process DP smoke: one full training step over a process group
(counterpart of ``nerf_fewshot_tpu/parallel/multihost_smoke.py``).

Each process:

1. joins the group (``initialize_multihost``: NCCL on a card, Gloo on the
   CPU, or ``--backend``),
2. builds the mesh over every rank,
3. loads only its own ray shard host-side: every process makes the same
   global ray set from one seed and gathers its rows (the trainer's
   ``view_packed[idx]`` row gather of packed ``[o|d|rgb]`` rows),
4. moves them to its device with ``make_global_batch`` (no data crosses
   ranks),
5. takes one DP train step and checks that the loss is finite: the plain
   render and autograd through ``data_parallel_train_step`` (the gradients
   averaged over the ranks), or with ``--kernels`` the loss and gradients
   of ``make_dp_fused_loss_grad`` (kernel 1 on a card, its plain version on
   the CPU), then Adam.

Run one process per rank::

    python -m nerf_fewshot_tpu_torch.parallel.multihost_smoke \\
        --coordinator host0:12345 --num-processes 2 --process-id <i> [--cpu]

``--cpu`` (``--device cpu``) runs the ranks on the CPU over Gloo;
``--backend gloo`` lets two ranks share one card.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
from nerf_fewshot_tpu_torch.parallel.fused_dp import make_dp_fused_loss_grad
from nerf_fewshot_tpu_torch.parallel.mesh import (
    data_parallel_train_step,
    initialize_multihost,
    make_global_batch,
    make_mesh,
    process_local_slice,
)
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays


def run_smoke(coordinator: str, num_processes: int, process_id: int, rays_per_host: int = 32,
              device: str = "cuda", backend: Optional[str] = None,
              kernels: bool = False) -> float:
    initialize_multihost(coordinator, num_processes, process_id, backend=backend, device=device)
    try:
        mesh = make_mesh(device)
        n_global = rays_per_host * num_processes
        rng = np.random.default_rng(0)
        rays_o = rng.standard_normal((n_global, 3)).astype(np.float32)
        rays_d = rng.standard_normal((n_global, 3)).astype(np.float32)
        targets = rng.uniform(0, 1, (n_global, 3)).astype(np.float32)
        sl = process_local_slice(n_global, mesh)
        packed = torch.from_numpy(np.concatenate([rays_o, rays_d, targets], axis=1))
        row = packed[torch.arange(sl.start, sl.stop)]
        ro, rd, tgt = make_global_batch(mesh, (row[:, 0:3], row[:, 3:6], row[:, 6:9]))

        hidden = 128 if kernels else 64  # the kernels take widths 128, 256, 384 and 512
        model = NeRFMLP(pos_freq=6, dir_freq=2, use_viewdirs=True, hidden_dim=hidden,
                        num_layers=3, generator=torch.Generator().manual_seed(0)).to(mesh.device)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        settings = RenderSettings(near=2.0, far=6.0, n_samples=8, perturb=False)
        if kernels:
            dp = make_dp_fused_loss_grad(mesh, settings, 6, 2, 3, hidden)
            loss, grads = dp(model, None, ro, rd, tgt, torch.ones(len(ro), device=mesh.device))
            for name, p in model.named_parameters():
                p.grad = grads[name]
            opt.step()
        else:
            step = data_parallel_train_step(
                lambda o, d, t: torch.mean((render_rays(model, o, d, settings).rgb - t) ** 2),
                opt, mesh)
            loss = step(ro, rd, tgt)
        loss_val = float(loss)
    finally:
        dist.destroy_process_group()
    if not np.isfinite(loss_val):
        raise RuntimeError(f"non-finite loss {loss_val}")
    print(f"multihost_smoke proc {process_id}/{num_processes}: devices={mesh.world_size} "
          f"loss={loss_val:.6f}", flush=True)
    return loss_val


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--rays-per-host", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card of the local rank) or cpu")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl on a card, gloo on the CPU)")
    p.add_argument("--kernels", action="store_true",
                   help="take the step through make_dp_fused_loss_grad (kernel 1)")
    a = p.parse_args(argv)
    run_smoke(a.coordinator, a.num_processes, a.process_id, rays_per_host=a.rays_per_host,
              device="cpu" if a.cpu else a.device, backend=a.backend, kernels=a.kernels)


if __name__ == "__main__":
    main()
