"""Full-Trainer multi-process smoke: the real training engine (phases,
padded batches, per-step row gathers, Adam) over a process group
(counterpart of ``nerf_fewshot_tpu/parallel/multihost_train_smoke.py``).

Each process builds the same synthetic dataset deterministically, joins
the group and trains ``--epochs`` epochs under ``Trainer(mesh=...)``; the
losses must agree across the ranks bit for bit. ``--kernels`` trains a
128-wide trunk on the kernel path, each step through
``make_dp_fused_loss_grad`` (kernel 1 on a card, its plain version on the
CPU); without it a 64-wide trunk trains on the plain path. Run one process
per rank::

    python -m nerf_fewshot_tpu_torch.parallel.multihost_train_smoke \\
        --coordinator host0:12345 --num-processes 2 --process-id <i> [--cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np
from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown
from nerf_fewshot_tpu_torch.training.config import config_from_dict
from nerf_fewshot_tpu_torch.training.trainer import Trainer


def _train(mesh, epochs: int, process_id: int, kernels: bool) -> list:
    """``epochs`` epochs of a small config on the mesh: the mean loss of each."""
    res = 16
    cfg = config_from_dict({
        "experiment": {"name": "multihost-train-smoke"},
        "data": {"resolution": res, "num_views": 2, "near": 2.0, "far": 6.0},
        "nerf_model": {"pos_freq": 6, "dir_freq": 2, "hidden_dim": 128 if kernels else 64,
                       "num_layers": 2, "sigma_bias": 0.1},
        "training": {"epochs": epochs, "phases": [
            {"start": 0, "H": res, "n_samples": 8, "batch_size": 128}]},
        "optimizer": {"lr": 5e-3, "weight_decay": 0.0, "lr_milestones": []},
        "rendering": {"chunk_size": 256, "white_bkgd": True,
                      "backend": "auto" if kernels else "xla"},
        "output": {"save_dir": os.path.join(tempfile.gettempdir(), f"mh_train_{process_id}"),
                   "val_freq": 1000, "save_freq": 1000},
    })
    data = make_scene_dataset(lego_like_scene(), n_views=2, img_size=res, gt_samples=32,
                              device=mesh.device)
    trainer = Trainer(cfg, data, mesh=mesh)
    if trainer._use_fused() != kernels:
        raise RuntimeError(f"the trainer took the {trainer.kernel_path} path "
                           f"({trainer.kernel_path_reason})")
    return [trainer.train_epoch(e) for e in range(epochs)]


def run(coordinator: str, num_processes: int, process_id: int, epochs: int = 2,
        device: str = "cuda", backend: Optional[str] = None, kernels: bool = False) -> float:
    initialize_multihost(coordinator, num_processes, process_id, backend=backend, device=device)
    try:
        mesh = make_mesh(device)
        losses = _train(mesh, epochs, process_id, kernels)
    finally:
        shutdown()  # the trainer, and its graphs, went with _train's frame
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite losses {losses}")
    print(f"multihost_train_smoke proc {process_id}/{num_processes}: devices={mesh.world_size} "
          f"kernel={'fused' if kernels else 'xla'} losses="
          + ",".join(f"{l:.6f}" for l in losses), flush=True)
    return losses[-1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card of the local rank) or cpu")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl on a card, gloo on the CPU)")
    p.add_argument("--kernels", action="store_true",
                   help="train on the kernel path, through make_dp_fused_loss_grad")
    a = p.parse_args(argv)
    run(a.coordinator, a.num_processes, a.process_id, epochs=a.epochs,
        device="cpu" if a.cpu else a.device, backend=a.backend, kernels=a.kernels)


if __name__ == "__main__":
    main()
