"""Train the baseline at the smoke's depth with one seed, from a given
checkout, and print its final loss, PSNR and step times as one JSON line;
or summarize such lines as pairs of two checkouts.

    python nerf_fewshot_tpu_torch/tools/train_runs.py --root DIR --seed S --tag T --out FILE
    python nerf_fewshot_tpu_torch/tools/train_runs.py --summarize FILE --base T1 --change T2

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the port of any checkout that has
them), builds ``experiments/baseline.yaml`` (``chip_smoke.BASELINE_CONFIG``)
with ``seed: S`` on the synthetic lego-like scene at 128x128 (5 train, 8
test views, the scene's own seed 0), and trains it through the kernel on
the card over the smoke's epochs (0, 1, 50, 100-103: 670 steps of 1024x32,
1024x48 and 512x64 rays x samples). It appends to ``--out``: the PSNR at
init and after, the last epoch's mean and last step losses, and the
milliseconds per step of epochs 101-103 (phase 2, untraced, each epoch
synchronized). Run the two checkouts alternately, in separate processes (they
share the package's name), A B B A ...; ``--summarize`` pairs the i-th run
of ``--base`` with the i-th of ``--change`` and prints each pair and the
mean and standard deviation of the differences.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

EPOCHS = (0, 1, 50, 100, 101, 102, 103)
TIMED = (101, 102, 103)


def run(root: str, seed: int, tag: str, out: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("train_runs: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = config_from_dict({**chip_smoke.BASELINE_CONFIG, "seed": seed})
    scene = lego_like_scene()
    res = cfg.data.resolution
    train = make_scene_dataset(scene, 5, img_size=res, seed=0, device=device)
    test = make_scene_dataset(scene, 8, img_size=res, seed=0, split="test", device=device)
    tr = Trainer(cfg, train, test, device=device)
    if not tr._use_fused():
        raise RuntimeError("the baseline must train through the kernel")
    psnr0 = tr.evaluate()["psnr"]
    for i in range(len(cfg.phases)):  # set-up, kept out of the step times
        tr.phase_data(i)
    ms, losses = {}, {}
    for e in EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[e] = tr.train_epoch(e)
        torch.cuda.synchronize()
        ms[e] = (time.perf_counter() - t0) / len(tr.last_step_losses) * 1e3
        if not np.isfinite(tr.last_step_losses).all():
            raise RuntimeError(f"epoch {e}: non-finite losses")
    rec = {"tag": tag, "root": root, "seed": seed, "psnr_init": psnr0,
           "psnr": tr.evaluate()["psnr"], "loss_last_epoch": losses[EPOCHS[-1]],
           "loss_last_step": float(tr.last_step_losses[-1]),
           "ms_per_step": {str(e): ms[e] for e in TIMED},
           "ms_per_step_mean": float(np.mean([ms[e] for e in TIMED]))}
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


def summarize(path: str, base: str, change: str) -> None:
    import numpy as np

    recs = [json.loads(line) for line in open(path) if line.strip()]
    a = [r for r in recs if r["tag"] == base]
    b = [r for r in recs if r["tag"] == change]
    n = min(len(a), len(b))
    print(f"{n} pairs ({base} -> {change}): seed, psnr, loss of the last epoch, ms per step")
    for x, y in zip(a[:n], b[:n]):
        print(f"  seed {x['seed']}/{y['seed']}: psnr {x['psnr']!r} -> {y['psnr']!r}, loss "
              f"{x['loss_last_epoch']!r} -> {y['loss_last_epoch']!r}, ms "
              f"{x['ms_per_step_mean']!r} -> {y['ms_per_step_mean']!r}")
    for key in ("psnr", "loss_last_epoch", "ms_per_step_mean"):
        d = np.array([y[key] - x[key] for x, y in zip(a[:n], b[:n])])
        sd = float(d.std(ddof=1)) if n > 1 else float("nan")
        print(f"  {key}: {base} mean {float(np.mean([x[key] for x in a[:n]]))!r}, {change} mean "
              f"{float(np.mean([y[key] for y in b[:n]]))!r}; difference mean {float(d.mean())!r}, "
              f"sd {sd!r}, {int((d > 0).sum())} of {n} above 0")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", help="the JSON-lines file a run appends to")
    ap.add_argument("--summarize")
    ap.add_argument("--base")
    ap.add_argument("--change")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize, args.base, args.change)
    elif not args.out:
        ap.error("a run needs --out")
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        run(args.root, args.seed, args.tag, args.out)


if __name__ == "__main__":
    main()
