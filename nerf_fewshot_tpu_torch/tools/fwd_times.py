"""Time the render forward kernels (kernels 2 and 4) and the eval render of a
128x128 view from a given checkout, and print them as one JSON line; or
summarize such lines as pairs of two checkouts.

    python nerf_fewshot_tpu_torch/tools/fwd_times.py --root DIR --tag T --out FILE
    python nerf_fewshot_tpu_torch/tools/fwd_times.py --summarize FILE --base T1 --change T2

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the port of any checkout that has
them) and times, with CUDA events (the mean of 20 launches after two warm-up
calls), on random inputs made from seed 0 by ``chip_smoke``'s generators at
the widths of the main paths (8x256 trunk, dir_freq 4):

- kernel 2 (``fused_render_fwd_pe``) at 2048x64, D 96 (a baseline eval
  chunk), at 512x64, D 96 (the hierarchical coarse pass), and at 1024x64 with
  64 and 128 features at pos_freq 12, D 176 and 240 (a DINO eval chunk);
- kernel 4 (``fused_render_fwd``) at 2048x64 from a 128-wide encoded x;
- the eval render: ``Trainer.render_views`` of the 8 test views of
  ``experiments/baseline.yaml`` (``chip_smoke.BASELINE_CONFIG``) on the
  synthetic lego-like scene at 128x128, in ms per view (host clock,
  synchronized; one warm-up view first).

Run the two checkouts alternately, in separate processes (they share the
package's name), A B B A ...; ``--summarize`` pairs the i-th run of
``--base`` with the i-th of ``--change`` and prints, per timing, each pair,
the means and the ratio change / base.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ITERS = 20


def run(root: str, tag: str, out: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("fwd_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    k2 = {}
    for label, R, fd, pos_freq in (("2048x64_d96", 2048, 0, 10), ("512x64_d96", 512, 0, 10),
                                   ("1024x64_d176", 1024, 64, 12),
                                   ("1024x64_d240", 1024, 128, 12)):
        x_dim = 6 + 6 * pos_freq + 24 + fd
        k2[label] = chip_smoke.random_fwd_pe_args(rng, R, 64, 256, 8, fd, device,
                                                  pos_freq=pos_freq, d_pad=tk.pe_width(x_dim))
    x4, _ = chip_smoke.random_render_args(rng, 2048, 64, 256, 8, device)
    ms = {f"kernel2_{label}": chip_smoke.cuda_ms(
              lambda: tk.fused_render_fwd_pe(*a, use_feats=a[1] is not None), iters=ITERS)
          for label, a in k2.items()}
    ms["kernel4_2048x64_x128"] = chip_smoke.cuda_ms(lambda: tk.fused_render_fwd(*x4),
                                                    iters=ITERS)

    cfg = config_from_dict(chip_smoke.BASELINE_CONFIG)
    scene = lego_like_scene()
    res = cfg.data.resolution
    train = make_scene_dataset(scene, 5, img_size=res, seed=0, device=device)
    test = make_scene_dataset(scene, 8, img_size=res, seed=0, split="test", device=device)
    tr = Trainer(cfg, train, test, device=device)
    if not tr._use_fused():
        raise RuntimeError("the baseline must render through the kernel")
    tr.render_views(test.poses[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.render_views(test.poses)
    torch.cuda.synchronize()
    ms["eval_ms_per_view"] = (time.perf_counter() - t0) / test.n_views * 1e3

    rec = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0), "ms": ms}
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
    print(f"{n} pairs ({base} -> {change}), ms:")
    for key in a[0]["ms"]:
        if key not in b[0]["ms"]:  # a grid launch the other build does not make
            print(f"  {key}: {base} only")
            continue
        x = np.array([r["ms"][key] for r in a[:n]])
        y = np.array([r["ms"][key] for r in b[:n]])
        pairs = ", ".join(f"{float(p)!r} -> {float(q)!r}" for p, q in zip(x, y))
        print(f"  {key}: {pairs}; means {float(x.mean())!r} -> {float(y.mean())!r}, ratio "
              f"{float(y.mean() / x.mean())!r}, change faster in {int((y < x).sum())} of {n}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
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
        run(args.root, args.tag, args.out)


if __name__ == "__main__":
    main()
