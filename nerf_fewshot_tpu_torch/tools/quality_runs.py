"""Train experiment configs end to end through the port's command line and
report their quality band: best PSNR, SSIM at the best PSNR, wall time and
dead-sigma epochs.

    python nerf_fewshot_tpu_torch/tools/quality_runs.py --out chiprun_out/quality.jsonl \
        [--configs baseline.yaml dino_nerf.yaml multiscale.yaml] [--epochs N] [--device cuda]

Each config runs as ``python -m nerf_fewshot_tpu_torch.cli train --config
experiments/<name> --synthetic`` in a fresh process, from a temporary
working directory (the configs' ``save_dir`` is relative), on the
procedural lego-like scene at the config's resolution (``num_views`` train
and 8 test views). The wall time covers the whole process: scene, DINO
feature maps, training with its every-``val_freq`` evals, checkpoints.
From the run's ``log.jsonl`` it takes every eval record's PSNR and SSIM;
from its summary JSON the final metrics and ``dead_sigma_epochs``. One JSON
line per config is appended to ``--out`` and printed, after a line with
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(name: str, epochs, device: str) -> dict:
    from nerf_fewshot_tpu_torch.training.config import load_config

    path = os.path.join(ROOT, "experiments", name)
    cfg = load_config(path)
    cmd = [sys.executable, "-m", "nerf_fewshot_tpu_torch.cli", "train", "--config", path,
           "--synthetic", "--device", device]
    if epochs is not None:
        cmd += ["--epochs", str(epochs)]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory(prefix="quality_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(tmp, cfg.output.save_dir, "log.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
    evals = [r for r in recs if "psnr" in r]
    best = max(evals, key=lambda r: r["psnr"]) if evals else {}
    train = [r for r in recs if "train_loss" in r]
    return {
        "config": name, "epochs": epochs if epochs is not None else cfg.epochs,
        "wall_s": wall, "best_psnr": summary["best_psnr"],
        "best_epoch": best.get("epoch"), "ssim_at_best": best.get("ssim"),
        "final_metrics": summary["final_metrics"],
        "dead_sigma_epochs": summary.get("dead_sigma_epochs", 0),
        "dead_sigma_records": sum(1 for r in recs if r.get("dead_sigma")),
        "last_train_loss": train[-1]["train_loss"] if train else None,
        "rays_per_sec_last_epoch": train[-1]["rays_per_sec"] if train else None,
        "evals": [(r["epoch"], r["psnr"], r["ssim"]) for r in evals],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+",
                    default=["baseline.yaml", "dino_nerf.yaml", "multiscale.yaml"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="the JSON-lines file each run appends to")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    for name in args.configs:
        rec = run(name, args.epochs, args.device)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
