"""Time the training-side kernels (kernels 1, 5 and 3: ``csrc/train_pe.cu``)
from a given checkout at the shapes and precision routes of ``PERF.md``'s
kernel tables, and print them as one JSON line; or summarize such lines as
pairs of two checkouts.

    python nerf_fewshot_tpu_torch/tools/train_times.py --root DIR --tag T --out FILE
    python nerf_fewshot_tpu_torch/tools/train_times.py --summarize FILE --base T1 --change T2

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the port of any checkout that has
them) and times, with CUDA events (the mean of 20 launches after two
warm-up calls), on random inputs made from seed 0 by ``chip_smoke``'s
generators (8x256 trunk, dir_freq 4):

- kernel 1 (``fused_train_objective``, inline PE) at ``float32``: D 96
  (pos_freq 10) at 1024x32, 1024x48, 512x64 and 512x128 rays x samples
  (the baseline's phase batches and the hierarchical step); at 512x64 with
  64 features at pos_freq 10 (D 160) and 12 (D 176), and 128 at 12 (D 240);
  the script recipes' D 832 (no view directions) and D 864 (768 features)
  at 4096x64 and 1024x32;
- kernel 5 (``inline_pe=False``) and kernel 3 (``fused_render_bwd`` with
  dx) at 512x64 from a 128-wide and an 896-wide x;
- kernels 1, 5 and 3 at ``bfloat16`` and ``highest`` at 512x64, D 96 / x
  128 and D 176 / x 256;
- the device time of each grid launch of kernels 1 and 3 at 512x64 (D 96,
  x 128) at each route (``chip_smoke.trace``), keyed ``<timing>:<launch>``.

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

ITERS = 20
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(root: str, tag: str, out: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt

    if not torch.cuda.is_available():
        raise SystemExit("train_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ms = {}

    def time_objective(label, R, S, cd="float32", **kw):
        a, o = chip_smoke.random_train_args(rng, R, S, 256, 8, device, **kw)
        o = {**o, "compute_dtype": cd}
        ms[label] = chip_smoke.cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=ITERS)
        del a, o

    def time_vjp(label, R, S, cd="float32", **kw):
        a, _ = chip_smoke.random_render_args(rng, R, S, 256, 8, device, **kw)
        cot = chip_smoke.random_cotangents(rng, R, S, device)
        ms[label] = chip_smoke.cuda_ms(lambda: tk.fused_render_bwd(*a, *cot, compute_dtype=cd),
                                       iters=ITERS)
        del a, cot

    for R, S in ((1024, 32), (1024, 48), (512, 64), (512, 128)):
        time_objective(f"kernel1_{R}x{S}_d96", R, S)
    for label, kw in (("d160", dict(feat_dim=64)), ("d176", dict(feat_dim=64, pos_freq=12)),
                      ("d240", dict(feat_dim=128, pos_freq=12))):
        time_objective(f"kernel1_512x64_{label}", 512, 64, **kw)
    for label, kw in (("d832", dict(feat_dim=768, use_viewdirs=False)),
                      ("d864", dict(feat_dim=768))):
        for R, S in ((4096, 64), (1024, 32)):
            time_objective(f"kernel1_{R}x{S}_{label}", R, S, **kw)
    for label, fd in (("x128", 0), ("x896", 768)):
        time_objective(f"kernel5_512x64_{label}", 512, 64, feat_dim=fd, inline_pe=False)
        time_vjp(f"kernel3_512x64_{label}", 512, 64, feat_dim=fd)
    for cd in ("bfloat16", "highest"):
        for label, kw in (("d96", {}), ("d176", dict(feat_dim=64, pos_freq=12))):
            time_objective(f"kernel1_512x64_{label}_{cd}", 512, 64, cd, **kw)
            time_objective(f"kernel5_512x64_{label}_{cd}", 512, 64, cd, inline_pe=False, **kw)
            time_vjp(f"kernel3_512x64_{label}_{cd}", 512, 64, cd, **kw)
        torch.cuda.empty_cache()

    # the device time of each grid launch of kernels 1 and 3 at 512x64 per
    # route (torch.profiler over 10 calls), as "<timing>:<launch>"
    a, o = chip_smoke.random_train_args(rng, 512, 64, 256, 8, device)
    rb, _ = chip_smoke.random_render_args(rng, 512, 64, 256, 8, device)
    cot = chip_smoke.random_cotangents(rng, 512, 64, device)
    for cd in ("float32", "bfloat16", "highest"):
        for label, fn in (
                (f"kernel1_512x64_d96_{cd}",
                 lambda: tt.fused_train_objective(*a, **{**o, "compute_dtype": cd})),
                (f"kernel3_512x64_x128_{cd}",
                 lambda: tk.fused_render_bwd(*rb, *cot, compute_dtype=cd))):
            fn()
            t = chip_smoke.trace(lambda: len([fn() for _ in range(10)]), with_cpu=False)
            ms.update({f"{label}:{part}": v for part, v in t["parts"].items()})

    rec = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0), "ms": ms}
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


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
        sys.path.insert(0, ROOT)
        from nerf_fewshot_tpu_torch.tools.fwd_times import summarize

        summarize(args.summarize, args.base, args.change)
    elif not args.out:
        ap.error("a run needs --out")
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        run(args.root, args.tag, args.out)


if __name__ == "__main__":
    main()
