"""Time the LoRA pack kernels (``csrc/lora_pack.cu``: ``lora_pack`` and
``lora_pack_vjp``) from a given checkout and print them as one JSON line; or
summarize such lines as pairs of two checkouts.

    python nerf_fewshot_tpu_torch/tools/lora_pack_times.py --root DIR --tag T --out FILE
    python nerf_fewshot_tpu_torch/tools/lora_pack_times.py --summarize FILE --base T1 --change T2

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the kernels of any checkout that has
them) and, on the inputs of ``chip_smoke.py``'s "LoRA pack kernels" phase
(seeded states, the inline-PE ``row_perm``, cotangents a third -0.0), times
each kernel with ``chip_smoke.graph_ms`` (20 calls in a CUDA graph, replayed
between CUDA events), ``REPS`` times, at ``lora_nerf_trunk.yaml``'s D 160 /
8x256 / rank 4, ``script_lora.yaml``'s D 832 and an 8x1024 trunk; and, where
the checkout's kernels take them, at rank 1024 and at 40 layers. It also
keeps a SHA-256 of the packed weights and of the gradients, so that two
checkouts' outputs can be held bit for bit.

Run the two checkouts alternately, in separate processes (they share the
package's name), A B B A ...; ``--summarize`` pairs the i-th run of
``--base`` with the i-th of ``--change`` and prints, per timing, each pair,
the means and the ratio change / base, and whether the outputs' hashes of
each case agree across every run of both (of the change alone for a case
the base does not take); it exits non-zero if they do not.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

REPS = 3
# label: (pos_freq, dir_freq, view directions, features, H, layers, rank), as
# chip_smoke.LORA_PACK_CASES; the last two only where the checkout takes them
CASES = {"lora_nerf_trunk.yaml": (10, 4, True, 64, 256, 8, 4),
         "script_lora.yaml": (10, 4, False, 768, 256, 8, 4),
         "H 1024": (10, 4, True, 64, 1024, 8, 4),
         "rank 1024": (10, 4, True, 64, 256, 8, 1024),
         "40 layers": (10, 4, True, 64, 256, 40, 4)}


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run(root: str, tag: str, out: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import lora_pack as lp

    if not torch.cuda.is_available():
        raise SystemExit("lora_pack_times: no CUDA device")
    device = torch.device("cuda", 0)
    deep = hasattr(lp, "launch_layers")  # the kernels take any rank and depth
    ms, bits = {}, {}
    for n_case, (label, (pos, dirs, vd, fd, H, L, r)) in enumerate(CASES.items()):
        if not deep and (L > 32 or r > 1020):
            continue
        consts = tk.pe_constants(pos, dirs, vd, fd, device)
        d_pad, perm = tk.pe_width(consts.x_dim), consts.row_perm
        state = chip_smoke.random_lora_state(np.random.default_rng(250 + n_case), consts.x_dim,
                                             H, L, r, device)
        args, vargs = (L, H, d_pad, perm, 16.0), (L, H, perm, 16.0)
        g = torch.Generator().manual_seed(n_case)
        cots = []
        for shape in lp.packed_shapes(L, H, d_pad):
            c = torch.randn(shape, generator=g)
            c[c.abs() < 0.45] = -0.0
            cots.append(c.to(device))
        cots = tuple(cots)
        packed = lp.pack_buffer(L, H, d_pad, device)
        grads = torch.empty(sum(v.numel() for v in state.values()), device=device)
        fwd = lambda: lp.lora_pack(state, *args, out=packed)
        vjp = lambda: lp.lora_pack_vjp(state, cots, *vargs, out=grads)
        fwd()
        vjp()
        torch.cuda.synchronize()
        bits[label] = {"fwd": _sha([packed]), "vjp": _sha([grads])}
        for key, fn in (("fwd", fwd), ("vjp", vjp)):
            ms[f"{key} {label}"] = [chip_smoke.graph_ms(fn) for _ in range(REPS)]
        del state, cots, packed, grads

    rec = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0), "ms": ms,
           "bits": bits}
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
    print(f"{n} pairs ({base} -> {change}), device ms a call (the least of each run's "
          f"{REPS} readings):")
    for key in b[0]["ms"]:
        if key not in a[0]["ms"]:
            print(f"  {key}: {change} only")
            continue
        x = np.array([min(r["ms"][key]) for r in a[:n]])
        y = np.array([min(r["ms"][key]) for r in b[:n]])
        pairs = ", ".join(f"{float(p)!r} -> {float(q)!r}" for p, q in zip(x, y))
        print(f"  {key}: {pairs}; means {float(x.mean())!r} -> {float(y.mean())!r}, ratio "
              f"{float(y.mean() / x.mean())!r}, change faster in {int((y < x).sum())} of {n}")
    differ = []
    for label in b[0]["bits"]:
        runs = [r["bits"][label] for r in (a if label in a[0]["bits"] else []) + b]
        same = all(x == runs[0] for x in runs)
        differ += [] if same else [label]
        print(f"  bits {label}: every run of {'both' if len(runs) > len(b) else change} "
              f"bit-equal: {same}")
    if differ:
        raise SystemExit(f"lora_pack_times: outputs not bit-equal across runs: {differ}")


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
