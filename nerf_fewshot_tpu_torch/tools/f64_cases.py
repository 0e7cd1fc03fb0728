"""Hold kernels 1, 5 and 3 (``csrc/train_pe.cu``) and their fp32 plain
versions against a float64 run, on the card tests' 37-ray cases and at
512x64, and time the two kernels at 512x64.

    python nerf_fewshot_tpu_torch/tools/f64_cases.py [--root DIR] [--out FILE]

The cases are ``TRAIN_CASES`` and ``RENDER_CASES`` of
``tests/test_torch_port_cuda.py`` (read from ``--root``), with the inputs
and shapes of ``test_train_kernel_matches_plain`` and
``test_render_bwd_kernel_matches_plain``. Each prints three relative
errors of the gradients (with dx for the render VJP): kernel vs fp32
plain version, kernel vs float64, fp32 plain version vs float64; and
whether the card test's gate holds. The float64 run is the plain version
on the same fp32 encoded input: at pos_freq 10 the PE phases reach ~2^9
rad, where a float64 PE would move x by more than the trunk's rounding,
and both fp32 routes share the exact-fp32 PE. On a 37-ray case one ReLU
gate that two routes round to different sides moves the gradient vector
by ~1e-3, so the third column tells which route flipped. A report for
comparing builds of the kernel, not a gate.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch


def to_f64(a):
    """``a`` with every floating tensor (also inside tuples) in float64."""
    if isinstance(a, tuple):
        return tuple(to_f64(x) for x in a)
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def objective_f64(a, o):
    """The plain objective in float64 for ``fused_train_objective(*a, **o)``,
    from the fp32 encoded input when ``o`` asks for inline PE."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt

    a, o = list(a), dict(o)
    if o.get("inline_pe", True):
        a[0] = tk._pe_input(a[0], a[1], a[7], a[8], a[9][0].shape[0])
        a[1] = None
        o["inline_pe"] = False
    return tt.fused_train_objective_reference(*to_f64(tuple(a)),
                                              **{k: to_f64(v) for k, v in o.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    import chip_smoke
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt

    if not torch.cuda.is_available():
        raise SystemExit("f64_cases: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(root, "tests", "test_torch_port_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts if t is not None])
    rel = lambda a, b: ((flat(a) - flat(b)).norm() / flat(b).norm()).item()

    def objective(R, S, H, L, seed, kw):
        a, o = chip_smoke.random_train_args(np.random.default_rng(seed), R, S, H, L, dev, **kw)
        k = tt.fused_train_objective(*a, **o)
        p = tt.fused_train_objective_reference(*a, **o)
        e = objective_f64(a, o)
        loss_rel = abs(k[0].item() - p[0].item()) / abs(p[0].item())
        return rel(k[1], p[1]), rel(k[1], e[1]), rel(p[1], e[1]), loss_rel

    def vjp(R, S, H, L, seed, kw):
        kw = dict(kw)
        white = kw.pop("white_bkgd", False)
        rng = np.random.default_rng(seed)
        ra, _ = chip_smoke.random_render_args(rng, R, S, H, L, dev, **kw)
        cot = chip_smoke.random_cotangents(rng, R, S, dev)
        k = tk.fused_render_bwd(*ra, *cot, white_bkgd=white)
        p = tk.fused_render_bwd_reference(*ra, *cot, white_bkgd=white)
        e = tk.fused_render_bwd_reference(*to_f64(tuple(ra)), *to_f64(tuple(cot)), white_bkgd=white)
        k, p, e = ((r[0], *r[1]) for r in (k, p, e))
        return rel(k, p), rel(k, e), rel(p, e), 0.0

    rows = []
    for H, L in ((256, 8), (128, 3)):
        for S in (32, 48, 64):
            for case, kw in sorted(card.TRAIN_CASES.items()):
                r = objective(37, S, H, L, 0, kw)
                tol = 2e-2 if case == "sigma_bias_5" else 1e-4
                rows.append((f"train_kernel[{case}-{H}-{L}-{S}]", *r, r[0] <= tol and r[3] <= 1e-5))
        for S in (32, 64, 128):
            for case, kw in sorted(card.RENDER_CASES.items()):
                r = vjp(37, S, H, L, 0, kw)
                tol = 2e-2 if case == "sigma_bias_5" else 1e-4
                rows.append((f"render_bwd[{case}-{H}-{L}-{S}]", *r, r[0] <= tol))
    print("case: kernel vs plain, kernel vs float64, plain vs float64 (gradients, rel)")
    for name, kp, ke, pe, _, ok in rows:
        print(f"  {name}: {kp:.3e}, {ke:.3e}, {pe:.3e}{'' if ok else '  FAILS the card gate'}")
    plain = [r for r in rows if "sigma_bias_5" not in r[0]]
    med = lambda i: float(np.median([r[i] for r in plain]))
    fails = [r[0] for r in rows if not r[5]]
    print(f"  {len(fails)} of {len(rows)} fail the card gates {fails}; medians without "
          f"sigma_bias 5.0: {med(1):.3e}, {med(2):.3e}, {med(3):.3e}")
    big = [("train_kernel 512x64", s, *objective(512, 64, 256, 8, s, {})[:3]) for s in range(4)]
    big += [("render_bwd 512x64", s, *vjp(512, 64, 256, 8, s, {})[:3]) for s in range(2)]
    for name, seed, kp, ke, pe in big:
        print(f"  {name} seed {seed}: {kp:.3e}, {ke:.3e}, {pe:.3e}")
    a, o = chip_smoke.random_train_args(np.random.default_rng(0), 512, 64, 256, 8, dev)
    k1 = chip_smoke.cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=30)
    rng = np.random.default_rng(0)
    ra, _ = chip_smoke.random_render_args(rng, 512, 64, 256, 8, dev)
    cot = chip_smoke.random_cotangents(rng, 512, 64, dev)
    k3 = chip_smoke.cuda_ms(lambda: tk.fused_render_bwd(*ra, *cot), iters=30)
    print(f"  kernel 1 at 512x64 {k1!r} ms, kernel 3 at 512x64 {k3!r} ms (CUDA events)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "main_shape": big, "fails": fails, "kernel1_ms": k1,
                       "kernel3_ms": k3}, f)


if __name__ == "__main__":
    main()
