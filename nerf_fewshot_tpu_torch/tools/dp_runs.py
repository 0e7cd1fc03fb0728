"""Train a config data parallel at world sizes 1..N, each world twice: as
CUDA graph replays (under NCCL each rank captures its step with the
all-reduce inside) and through the eager step (``Trainer(_eager_step=True)``),
and print, per world size, one JSON line: each run's step mode and ms per
step of each epoch (and whether the epoch captured a graph), whether the
graph's losses, parameters and Adam moments equal the eager step's and the
ranks each other's, kernel-1 launches per rank and the ray count of each
call, one replay's launches, the step's all-reduce timed alone (eager, and
on NCCL as graph replays) and its share of a graphed step, and the per-step
losses' largest relative gap to the no-mesh run.

    python nerf_fewshot_tpu_torch/tools/dp_runs.py --worlds 1 2 4 \
        [--epochs 0 1 50 51 100 101] [--config experiments/script_projection.yaml] \
        [--out FILE]
    python nerf_fewshot_tpu_torch/tools/dp_runs.py --device cpu --small --worlds 1 2

The run builds ``experiments/baseline.yaml`` (``chip_smoke.BASELINE_CONFIG``
from ``--root``), or the file ``--config`` names (DINO-conditioned configs
on their extractor's maps of the scene, made once here), on the synthetic
lego-like scene at its resolution (``--small``: a 3x128 trunk at 32x32 with
batches of 64, for a rehearsal on the CPU). The reference is ``Trainer``
with no mesh in this process; world N spawns N ranks
(``parallel.mesh.launch``), rank i on ``cuda:i`` over NCCL, or on the CPU
over Gloo with ``--device cpu`` (eager: Gloo cannot be captured). Every
rank draws the batch's jitter and takes its rows, so world N follows no
mesh up to the order of the sums. ``chip_smoke.py`` runs the same
functions for its data-parallel phase.
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

EPOCHS = (0, 1, 50, 51, 100, 101)
ALLREDUCE_ITERS = 20
SMALL = {"data": {"resolution": 32}, "nerf_model": {"hidden_dim": 128, "num_layers": 3},
         "training": {"batch_size": 64}, "rendering": {"chunk_size": 256}}
MODES = ("graph", "eager")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_trainer(cfg_dict: Dict, mesh=None, device=None, with_test: bool = False,
               dino_features: Optional[np.ndarray] = None, eager: bool = False):
    """The config's trainer on the synthetic scene at its resolution (5
    train views; 8 test views with ``with_test``), under ``mesh`` or on
    ``device`` without one, conditioned on ``dino_features`` when given;
    ``eager``: the card's eager step (``Trainer(_eager_step=True)``)."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict(cfg_dict)
    dev = mesh.device if mesh is not None else device
    test = _scene(cfg, dev, "test") if with_test else None
    return Trainer(cfg, _scene(cfg, dev), test, device=dev, mesh=mesh,
                   dino_features=dino_features, _eager_step=eager)


def _scene(cfg, device, split: str = "train"):
    """The synthetic lego-like scene at the config's resolution: 5 train or
    8 test views."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset

    return make_scene_dataset(lego_like_scene(), 5 if split == "train" else 8,
                              img_size=cfg.data.resolution, seed=cfg.seed, split=split,
                              device=device)


def dp_run(trainer, epochs: Sequence[int]) -> Dict:
    """Train ``epochs``: each epoch's per-step losses, ms per step (host
    clock around synchronized epochs) and whether it captured a graph,
    kernel 1's and the feature sampler's launches (counted from 0 here) and
    the LoRA pack kernels' launches (``lora_launches``: the packing's and
    the VJP's, counted from 0 here), the ray count of each call of kernel
    1's wrapper (a replay calls none),
    the step mode and its reason, one replay's launches, the parameters and
    the Adam moments by name."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.render.lora_pack import lora_pack, lora_pack_vjp
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features

    for e in epochs:
        trainer.phase_data(trainer._phase_index(e))  # set-up, outside the times
    orig = tt.fused_train_objective
    rays = []

    def recorded(*args, **kw):  # the calls' shapes; the count stays the kernel's
        rays.append(args[2].shape[0])
        return orig(*args, **kw)

    orig.launches["train_pe"] = 0
    sample_point_features.launches = lora_pack.launches = lora_pack_vjp.launches = 0
    recorded.launches = orig.launches
    tt.fused_train_objective = recorded
    steps, ms, captured = [], [], []
    try:
        for e in epochs:
            _sync(trainer.device)
            captures = len(trainer.graph_captures)
            t0 = time.perf_counter()
            trainer.train_epoch(e)
            _sync(trainer.device)
            steps.append(trainer.last_step_losses)
            ms.append((time.perf_counter() - t0) * 1e3 / len(trainer.last_step_losses))
            captured.append(len(trainer.graph_captures) > captures)
    finally:
        tt.fused_train_objective = orig
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opt = trainer.optimizer
    adam = {names[id(p)]: {k: opt.state[p][k].cpu().numpy() for k in ("exp_avg", "exp_avg_sq")}
            for p in opt.param_groups[0]["params"]}
    caps = trainer.graph_captures
    return {"steps": steps, "ms_per_step": ms, "captured": captured,
            "launches": orig.launches["train_pe"],
            "sampler_launches": sample_point_features.launches, "rays": rays,
            "lora_launches": [lora_pack.launches, lora_pack_vjp.launches],
            "step_mode": trainer.step_mode, "step_mode_reason": trainer.step_mode_reason,
            "launches_per_replay": dict(caps[-1]["launches_per_replay"]) if caps else None,
            "params": {k: v.cpu().numpy() for k, v in trainer.model.state_dict().items()},
            "adam": adam}


def collective_ms(mesh, n_params: int) -> Dict[str, Optional[float]]:
    """ms of the mesh step's all-reduce (the loss and every gradient:
    ``1 + n_params`` floats, in place) timed alone: ``eager``, host clock
    around ALLREDUCE_ITERS synchronized calls; ``graph``, on an NCCL mesh of
    two ranks or more, device time per call of ALLREDUCE_ITERS calls
    captured in one CUDA graph (CUDA events around a replay), else None (at
    world 1 the in-place all-reduce enqueues no device work: its graph is
    empty)."""
    from nerf_fewshot_tpu_torch.parallel.mesh import all_reduce_sum_, can_capture

    buf = torch.zeros(1 + n_params, device=mesh.device)
    all_reduce_sum_(mesh, buf)  # the communicator, before the capture
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_ITERS):
        all_reduce_sum_(mesh, buf)
    _sync(mesh.device)
    out = {"eager": (time.perf_counter() - t0) * 1e3 / ALLREDUCE_ITERS, "graph": None}
    if can_capture(mesh) and mesh.world_size > 1:
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(mesh.device)
        side.wait_stream(torch.cuda.current_stream(mesh.device))
        with torch.cuda.stream(side):
            all_reduce_sum_(mesh, buf)
            graph.capture_begin()
            for _ in range(ALLREDUCE_ITERS):
                all_reduce_sum_(mesh, buf)
            graph.capture_end()
        torch.cuda.current_stream(mesh.device).wait_stream(side)
        all_reduce_sum_.launches -= ALLREDUCE_ITERS  # the capture ran nothing
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out["graph"] = start.elapsed_time(end) / ALLREDUCE_ITERS
    return out


def dp_rank(mesh, cfg_dict: Dict, epochs: Sequence[int],
            dino_features: Optional[np.ndarray] = None, eager: bool = False) -> Dict:
    """One rank of a DP run (a spawned process): ``dp_run`` (``eager``: the
    card's eager step) and the all-reduce's times on its mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = dp_trainer(cfg_dict, mesh, dino_features=dino_features, eager=eager)
    out = dp_run(trainer, epochs)
    out["collective_ms"] = collective_ms(mesh, sum(p.numel() for p in
                                                   trainer.model.parameters()))
    return out


def dp_rank_modes(mesh, cfg_dict: Dict, epochs: Sequence[int],
                  dino_features: Optional[np.ndarray] = None) -> Dict:
    """One rank of a DP run in both step modes, one after the other in
    this process (a fresh trainer each, the same seed): ``{"graph": ...,
    "eager": ...}`` of ``dp_rank``."""
    return {mode: dp_rank(mesh, cfg_dict, epochs, dino_features, eager=mode == "eager")
            for mode in MODES}


def run_difference(a: Dict, b: Dict) -> Optional[str]:
    """What differs between two ``dp_run`` results' per-step losses,
    parameters and Adam moments, bit for bit; None when nothing does."""
    for i, (x, y) in enumerate(zip(a["steps"], b["steps"])):
        if not np.array_equal(x, y):
            return f"epoch {i}'s per-step losses (max rel {np.abs(x / y - 1).max():.3e})"
    for k, v in b["params"].items():
        if not np.array_equal(a["params"][k], v):
            return f"parameter {k}"
    for k, v in b["adam"].items():
        for m in v:
            if not np.array_equal(a["adam"][k][m], v[m]):
                return f"Adam {m} of {k}"
    return None


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
    """One world size's JSON record (``runs``: each rank's ``dp_rank_modes``)
    against the no-mesh run ``one``."""
    r0 = {m: runs[0][m] for m in MODES}
    rec = {"world": world, "epochs": list(epochs),
           "steps": [len(s) for s in r0["graph"]["steps"]],
           "ranks_bit_equal": all(run_difference(r[m], r0[m]) is None
                                  for r in runs[1:] for m in MODES),
           "graph_equal_eager": all(run_difference(r["graph"], r["eager"]) is None
                                    for r in runs),
           "launches_per_rank": [r["graph"]["launches"] for r in runs],
           "rays_per_call": sorted(set(r0["eager"]["rays"])),
           "launches_per_replay": r0["graph"]["launches_per_replay"],
           "max_rel_to_no_mesh": {str(e): float(np.abs(a / b - 1).max()) for e, a, b in
                                  zip(epochs, r0["graph"]["steps"], one["steps"])}}
    for m in MODES:
        r = r0[m]
        rec[m] = {"step_mode": r["step_mode"], "step_mode_reason": r["step_mode_reason"],
                  "ms_per_step": {str(e): x for e, x in zip(epochs, r["ms_per_step"])},
                  "captured": [e for e, c in zip(epochs, r["captured"]) if c]}
    ar = r0["graph"]["collective_ms"]
    rec["collective_ms"] = ar
    replays = [x for x, c in zip(r0["graph"]["ms_per_step"], r0["graph"]["captured"]) if not c]
    if ar["graph"] is not None and replays:  # against the last epoch that only replayed
        rec["collective_share_of_a_step"] = ar["graph"] / replays[-1]
    else:  # no graph of it (gloo, or world 1: no device work): eager against eager
        rec["collective_share_of_a_step"] = ar["eager"] / r0["eager"]["ms_per_step"][-1]
    return rec


def _config_dict(root: str, config: Optional[str], small: bool) -> Dict:
    sys.path.insert(0, os.path.abspath(root))
    if config is None:
        import chip_smoke

        cfg = dict(chip_smoke.BASELINE_CONFIG)
    else:
        from nerf_fewshot_tpu_torch.training.config import load_config

        cfg = load_config(config).raw
    if small:
        cfg = {k: {**v, **SMALL.get(k, {})} if isinstance(v, dict) else v for k, v in cfg.items()}
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".", help="the checkout whose chip_smoke.py holds the config")
    p.add_argument("--config", default=None,
                   help="an experiment file to run instead of chip_smoke.BASELINE_CONFIG")
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    p.add_argument("--epochs", type=int, nargs="+", default=list(EPOCHS))
    p.add_argument("--device", default="cuda", help="cuda (one rank per card) or cpu")
    p.add_argument("--small", action="store_true", help="a 3x128 trunk at 32x32 (CPU rehearsal)")
    p.add_argument("--timeout", type=float, default=3000.0, help="seconds for each world's ranks")
    p.add_argument("--out", default=None, help="append the JSON lines to this file")
    a = p.parse_args(argv)
    cfg = _config_dict(a.root, a.config, a.small)

    from nerf_fewshot_tpu_torch.parallel.mesh import launch

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
    feats = None
    if cfg.get("model", {}).get("use_dino"):
        from nerf_fewshot_tpu_torch.cli import _precompute_features
        from nerf_fewshot_tpu_torch.training.config import config_from_dict

        c = config_from_dict(cfg)
        feats = np.asarray(_precompute_features(c, _scene(c, device), device))
    one = dp_run(dp_trainer(cfg, device=device, dino_features=feats), a.epochs)
    print(json.dumps({"card": card, "config": a.config or "baseline", "world": 0,
                      "backend": "none", "step_mode": one["step_mode"],
                      "ms_per_step": {str(e): x for e, x in zip(a.epochs, one["ms_per_step"])},
                      "captured": [e for e, c in zip(a.epochs, one["captured"]) if c]}),
          flush=True)
    for world in a.worlds:
        devices = (["cpu"] * world if device.type == "cpu"
                   else [torch.device("cuda", i) for i in range(world)])
        runs = launch(dp_rank_modes, devices, (cfg, a.epochs, feats), timeout_s=a.timeout)
        rec = {"card": card, "config": a.config or "baseline",
               "backend": "gloo" if device.type == "cpu" else "nccl",
               **summary(world, runs, one, a.epochs)}
        print(json.dumps(rec), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
