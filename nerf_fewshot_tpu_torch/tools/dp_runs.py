"""Train the baseline data parallel at world sizes 1..N and print, per
world size, one JSON line: ms per step of each epoch, the two all-reduces'
ms and share of a step, kernel-1 launches per rank and the ray count of
each call, whether the ranks agree bit for bit, and the per-step losses'
largest relative gap to the one-device run.

    python nerf_fewshot_tpu_torch/tools/dp_runs.py --worlds 1 2 4 [--epochs 0 1 50 100] \\
        [--out FILE]
    python nerf_fewshot_tpu_torch/tools/dp_runs.py --device cpu --small --worlds 1 4

The run builds ``experiments/baseline.yaml`` (``chip_smoke.BASELINE_CONFIG``
from ``--root``) on the synthetic lego-like scene at 128x128 (``--small``:
a 3x128 trunk at 32x32 with batches of 64, for a rehearsal on the CPU).
World 1 is ``Trainer`` with no mesh in this process; world N spawns N ranks
(``parallel.mesh.launch``), rank i on ``cuda:i`` over NCCL, or on the CPU
over Gloo with ``--device cpu``. Every rank draws the batch's jitter and
takes its rows, so world N follows world 1 up to the order of the sums.
``chip_smoke.py`` runs the same functions for its data-parallel phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

EPOCHS = (0, 1, 50, 100)
ALLREDUCE_ITERS = 20
SMALL = {"data": {"resolution": 32}, "nerf_model": {"hidden_dim": 128, "num_layers": 3},
         "training": {"batch_size": 64}, "rendering": {"chunk_size": 256}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_trainer(cfg_dict: Dict, mesh=None, device=None, with_test: bool = False,
               dino_features: Optional[np.ndarray] = None):
    """The config's trainer on the synthetic scene at its resolution (5
    train views; 8 test views with ``with_test``), under ``mesh`` or on
    ``device`` without one, conditioned on ``dino_features`` when given."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict(cfg_dict)
    dev = mesh.device if mesh is not None else device
    res = cfg.data.resolution
    train = make_scene_dataset(lego_like_scene(), 5, img_size=res, seed=cfg.seed, device=dev)
    test = (make_scene_dataset(lego_like_scene(), 8, img_size=res, seed=cfg.seed, split="test",
                               device=dev) if with_test else None)
    return Trainer(cfg, train, test, device=dev, mesh=mesh, dino_features=dino_features)


def dp_run(trainer, epochs: Sequence[int]) -> Dict:
    """Train ``epochs``: each epoch's per-step losses and ms per step (host
    clock around synchronized epochs), kernel 1's and the feature sampler's
    launches (counted from 0 here) and the ray count of each call of kernel
    1's wrapper, the parameters."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features

    for e in epochs:
        trainer.phase_data(trainer._phase_index(e))  # set-up, outside the times
    orig = tt.fused_train_objective
    rays = []

    def recorded(*args, **kw):  # the calls' shapes; the count stays the kernel's
        rays.append(args[2].shape[0])
        return orig(*args, **kw)

    orig.launches["train_pe"] = 0
    sample_point_features.launches = 0
    recorded.launches = orig.launches
    tt.fused_train_objective = recorded
    steps, ms = [], []
    try:
        for e in epochs:
            _sync(trainer.device)
            t0 = time.perf_counter()
            trainer.train_epoch(e)
            _sync(trainer.device)
            steps.append(trainer.last_step_losses)
            ms.append((time.perf_counter() - t0) * 1e3 / len(trainer.last_step_losses))
    finally:
        tt.fused_train_objective = orig
    return {"steps": steps, "ms_per_step": ms, "launches": orig.launches["train_pe"],
            "sampler_launches": sample_point_features.launches,
            "rays": rays, "params": {k: v.cpu().numpy() for k, v in
                                     trainer.model.state_dict().items()}}


def allreduce_ms(mesh, n_params: int) -> Dict[str, float]:
    """ms of the DP step's two all-reduces on this mesh: the valid-ray
    count (1 float) and the loss with every gradient (1 + n_params)."""
    from nerf_fewshot_tpu_torch.parallel.mesh import all_reduce_sum

    out = {}
    for name, n in (("count", 1), ("loss_and_grads", 1 + n_params)):
        buf = torch.ones(n, device=mesh.device)
        all_reduce_sum(mesh, [buf])
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(ALLREDUCE_ITERS):
            all_reduce_sum(mesh, [buf])
        _sync(mesh.device)
        out[name] = (time.perf_counter() - t0) * 1e3 / ALLREDUCE_ITERS
    return out


def dp_rank(mesh, cfg_dict: Dict, epochs: Sequence[int],
            dino_features: Optional[np.ndarray] = None) -> Dict:
    """One rank of a DP run (a spawned process): ``dp_run`` and the
    all-reduce times on its mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = dp_trainer(cfg_dict, mesh, dino_features=dino_features)
    out = dp_run(trainer, epochs)
    out["allreduce_ms"] = allreduce_ms(mesh, sum(p.numel() for p in trainer.model.parameters()))
    return out


def sampler_rank(mesh, inputs: Dict) -> Dict:
    """One rank of the feature sampler's ``invalid_fill: mean`` across
    ranks (a spawned process): ``inputs`` the wrapper's arguments with
    numpy arrays; this rank's contiguous rows of the points sampled by the
    kernel (twice) and by its plain version, each with the mean's sums and
    point count all-reduced over the ranks; returns ``(features, valid)``
    of each as numpy and the kernel's launches."""
    from nerf_fewshot_tpu_torch.parallel.mesh import all_reduce_sum, process_local_slice
    from nerf_fewshot_tpu_torch.render import point_features as tpf

    a = {k: torch.as_tensor(v, device=mesh.device) if isinstance(v, np.ndarray) else v
         for k, v in inputs.items()}
    a["pts"] = a["pts"][process_local_slice(a["pts"].shape[0], mesh)].contiguous()

    def batch_sum(s, n):
        (total,) = all_reduce_sum(mesh, [s])
        return total, n * mesh.world_size

    def call(fn):
        kw = dict(a)
        f, valid = fn(kw.pop("pts"), kw.pop("maps"), kw.pop("view"), kw.pop("pose_mats"),
                      kw.pop("focal"), kw.pop("H"), kw.pop("W"), batch_sum=batch_sum, **kw)
        return f.cpu().numpy(), valid.cpu().numpy()

    before = tpf.sample_point_features.launches
    kernel, again = call(tpf.sample_point_features_valid), call(tpf.sample_point_features_valid)
    launches = tpf.sample_point_features.launches - before
    return {"kernel": kernel, "again": again, "plain": call(tpf.point_features_reference),
            "launches": launches}


def summary(world: int, runs: Sequence[Dict], one: Dict, epochs: Sequence[int]) -> Dict:
    """One world size's JSON record against the one-device run ``one``."""
    r0 = runs[0]
    equal = all(np.array_equal(a, b) for r in runs[1:] for a, b in zip(r["steps"], r0["steps"]))
    equal = equal and all(np.array_equal(r["params"][k], v) for r in runs[1:]
                          for k, v in r0["params"].items())
    rec = {"world": world, "epochs": list(epochs),
           "steps": [len(s) for s in r0["steps"]],
           "ms_per_step": {str(e): m for e, m in zip(epochs, r0["ms_per_step"])},
           "launches_per_rank": [r["launches"] for r in runs],
           "rays_per_call": sorted(set(r0["rays"])), "ranks_bit_equal": bool(equal),
           "max_rel_to_world_1": {str(e): float(np.abs(a / b - 1).max())
                                  for e, a, b in zip(epochs, r0["steps"], one["steps"])}}
    if "allreduce_ms" in r0:
        ar = r0["allreduce_ms"]
        rec["allreduce_ms"] = ar
        rec["allreduce_share_of_last_epoch_step"] = (
            (ar["count"] + ar["loss_and_grads"]) / r0["ms_per_step"][-1])
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".", help="the checkout whose chip_smoke.py holds the config")
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    p.add_argument("--epochs", type=int, nargs="+", default=list(EPOCHS))
    p.add_argument("--device", default="cuda", help="cuda (one rank per card) or cpu")
    p.add_argument("--small", action="store_true", help="a 3x128 trunk at 32x32 (CPU rehearsal)")
    p.add_argument("--out", default=None, help="append the JSON lines to this file")
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import chip_smoke

    from nerf_fewshot_tpu_torch.parallel.mesh import launch

    cfg = dict(chip_smoke.BASELINE_CONFIG)
    if a.small:
        cfg = {k: {**v, **SMALL.get(k, {})} if isinstance(v, dict) else v for k, v in cfg.items()}
    device = torch.device(a.device if a.device == "cpu" else "cuda:0")
    card = "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        if len(set(card)) != 1:
            raise RuntimeError(f"the cards differ: {card}")
        card = card[0]
    one = dp_run(dp_trainer(cfg, device=device), a.epochs)
    for world in a.worlds:
        if world == 1:
            runs = [one]
        else:
            devices = (["cpu"] * world if device.type == "cpu"
                       else [torch.device("cuda", i) for i in range(world)])
            runs = launch(dp_rank, devices, (cfg, a.epochs), timeout_s=3000)
        rec = {"card": card, "backend": "none" if world == 1 else
               ("gloo" if device.type == "cpu" else "nccl"),
               **summary(world, runs, one, a.epochs)}
        print(json.dumps(rec), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
