"""Train experiment configs end to end through the port's command line and
report their quality band: best PSNR, SSIM and LPIPS (with its
``lpips_backend``) at the best PSNR, wall time and dead-sigma epochs.

    python nerf_fewshot_tpu_torch/tools/quality_runs.py --out chiprun_out/quality.jsonl \
        [--configs baseline.yaml dino_nerf.yaml multiscale.yaml] [--epochs N] [--seed S] \
        [--backend xla] [--compute-dtype bfloat16] [--features MAPS.npz] [--device cuda]

Each config runs as ``python -m nerf_fewshot_tpu_torch.cli train --config
experiments/<name> --synthetic`` in a fresh process, from a temporary
working directory (the configs' ``save_dir`` is relative), on the
procedural lego-like scene at the config's resolution (``num_views`` train
and 8 test views). The wall time covers the whole process: scene, DINO
feature maps, training with its every-``val_freq`` evals, checkpoints.
``--seed`` runs a copy of the file with a top-level ``seed:`` (the files
set none, so they run at 0): the model init, the minibatch order, the
jitter and the DINO extractors' init follow it; the scene does not.
``--backend xla`` runs a copy with ``rendering.backend: xla``: the plain
pipeline and autograd instead of the kernels, to tell the kernels' numerics
from a recipe's own dynamics; ``--compute-dtype`` a copy with
``rendering.compute_dtype`` set, the kernels' precision route (``bfloat16``:
one bf16 pass per product, the rounding the TPU runs had); ``--features``
trains on the feature maps of an ``.npz`` (``cli train --features``, for
example the JAX package's maps from ``tools/export_multiscale_maps.py``)
instead of the config's extractor's. A
config with ``log_format: "csv"`` runs as a copy with the JSONL sink: the
CSV sink keeps only the first record's columns, so its eval rows carry no
PSNR. From the run's ``log.jsonl`` it takes every eval record's PSNR, SSIM
and LPIPS;
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


def run(name: str, epochs, device: str, seed=None, backend=None, compute_dtype=None,
        features=None) -> dict:
    from nerf_fewshot_tpu_torch.training.config import load_config

    path = os.path.join(ROOT, "experiments", name)
    cfg = load_config(path)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory(prefix="quality_") as tmp:
        if (seed is not None or backend is not None or compute_dtype is not None
                or cfg.output.log_format == "csv"):
            if seed is not None and "seed" in cfg.raw:
                raise ValueError(f"{name} sets its own seed")
            with open(path) as f:
                text = f.read().replace('log_format: "csv"', 'log_format: "jsonl"')
            for key, value in (("backend", backend), ("compute_dtype", compute_dtype)):
                if value is not None:
                    text = text.replace("\nrendering:\n", f"\nrendering:\n  {key}: {value}\n")
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(text + ("" if seed is None else f"\nseed: {seed}\n"))
            cfg = load_config(path)
            if (cfg.output.log_format != "jsonl" or backend not in (None, cfg.rendering.backend)
                    or compute_dtype not in (None, cfg.rendering.compute_dtype)):
                raise ValueError(f"{name}: could not switch its log to JSONL, its backend or "
                                 f"its compute_dtype")
        cmd = [sys.executable, "-m", "nerf_fewshot_tpu_torch.cli", "train", "--config", path,
               "--synthetic", "--device", device]
        if epochs is not None:
            cmd += ["--epochs", str(epochs)]
        if features is not None:
            cmd += ["--features", os.path.abspath(features)]
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
        "config": name, "seed": cfg.seed, "backend": cfg.rendering.backend,
        "compute_dtype": cfg.rendering.compute_dtype, "features": features,
        "epochs": epochs if epochs is not None else cfg.epochs,
        "wall_s": wall, "best_psnr": summary["best_psnr"],
        "best_epoch": best.get("epoch"), "ssim_at_best": best.get("ssim"),
        "lpips_at_best": best.get("lpips"), "lpips_backend": best.get("lpips_backend"),
        "final_metrics": summary["final_metrics"],
        "dead_sigma_epochs": summary.get("dead_sigma_epochs", 0),
        "dead_sigma_records": sum(1 for r in recs if r.get("dead_sigma")),
        "last_train_loss": train[-1]["train_loss"] if train else None,
        "rays_per_sec_last_epoch": train[-1]["rays_per_sec"] if train else None,
        "evals": [(r["epoch"], r["psnr"], r["ssim"], r.get("lpips")) for r in evals],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+",
                    default=["baseline.yaml", "dino_nerf.yaml", "multiscale.yaml"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="run each config at this seed (default: the file's, 0)")
    ap.add_argument("--backend", default=None, choices=["auto", "fused", "xla"],
                    help="run each config with this rendering.backend (default: the file's)")
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16", "highest"],
                    help="run each config with this rendering.compute_dtype (default: the "
                         "file's, float32)")
    ap.add_argument("--features", default=None, metavar="NPZ",
                    help="train on the feature maps in NPZ (cli train --features) instead of "
                         "the config's extractor's")
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
        rec = run(name, args.epochs, args.device, args.seed, args.backend, args.compute_dtype,
                  args.features)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
