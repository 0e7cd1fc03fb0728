"""Save the five kernels' outputs at every precision route on fixed
inputs from a given checkout, or compare two such files bit for bit: the
check that a change to the kernels' sources left the builds it did not
mean to change as they were.

    python nerf_fewshot_tpu_torch/tools/route_bits.py --root DIR --out FILE.pt \
        [--inputs EARLIER.pt]
    python nerf_fewshot_tpu_torch/tools/route_bits.py --compare A.pt B.pt \
        [--reordered NAME_PREFIX ...]

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the port of any checkout that has them;
run each checkout in its own process, as they share the package's name),
builds its kernels, and calls each at ``compute_dtype`` ``float32``,
``bfloat16`` and ``highest`` on the inputs ``chip_smoke`` makes: at trunk
width 256 for the main path, ``experiments/baseline.yaml`` at its seed on
the synthetic scene (kernels 2 and 4 on a 2048x64 eval chunk, kernels 1, 5
and 3 on the phase-2 batch of 512x64), and at the DINO width (pos_freq 12,
64 features: D 176 inline, a 256-wide x) from seed 0; at trunk width 128
(3 layers, 64 features) from seed 1; at trunk widths 384 and 512 (3
layers, 64 features, 512 rays x 64 samples) from seeds 2 and 3. Call names
end in the route. The file
holds the outputs and a digest of the inputs; ``--compare`` fails unless
both files saw the same inputs and every output tensor is bit-equal.
A run saves its calls' input tensors too; ``--inputs`` takes them from an
earlier run's file instead of the tree's own glue, so that the kernels of
two trees whose host glue rounds the inputs apart (the samples, say) are
still compared on the same inputs.
``--reordered`` names the calls (by prefix) whose kernel sums in another
order in the second tree, by design: those are reported, with the
relative difference of their outputs as one vector, and not gated. A run
also prints ptxas' registers and spills of the compositing and dW kernels
of the tree's ``train_pe.cu`` build.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

ROUTES = ("float32", "bfloat16", "highest")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _map(fn, a):
    """``a`` with every tensor in it (tuples, lists, dict values) mapped."""
    if isinstance(a, (tuple, list)):
        return type(a)(_map(fn, x) for x in a)
    if isinstance(a, dict):
        return {k: _map(fn, v) for k, v in a.items()}
    return fn(a) if hasattr(a, "detach") else a


def print_registers(compiler_log: str, names=("composite", "train_dw")) -> None:
    """ptxas' register and spill lines (``-Xptxas -v``) of the kernels whose
    entry name holds one of ``names``, one line per template instance."""
    import re

    entry = None
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(n in m.group(1) for n in names) else None
        elif entry and ("spill" in line or "Used" in line):
            short = re.search(r"\d+((?:train|render)_\w+?_kernel)I(\w+?)E", entry)
            label = f"{short.group(1)}<{short.group(2)}>" if short else entry
            print(f"  ptxas {label}: {line.split(':', 1)[-1].strip()}", flush=True)


def run(root: str, out: str, inputs=None) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.render import cuda_build
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("route_bits: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = config_from_dict(chip_smoke.BASELINE_CONFIG)
    res = cfg.data.resolution
    train = make_scene_dataset(lego_like_scene(), 5, img_size=res, seed=cfg.seed, device=device)
    test = make_scene_dataset(lego_like_scene(), 8, img_size=res, seed=cfg.seed, split="test",
                              device=device)
    trainer = Trainer(cfg, train, test, device=device)
    last = len(cfg.phases) - 1
    rng = np.random.default_rng(0)
    flat = lambda r: [r[0], *r[1]]
    calls = {}

    def add(name, fn, *args, **kw):
        inputs = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
                  if torch.is_tensor(t)]
        calls[name] = (fn, args, kw, _digest(inputs))

    add("fwd_pe_d96", tk.fused_render_fwd_pe, *chip_smoke.main_path_fwd_pe_args(
        trainer, test.poses[0], device))
    add("fwd_d96", tk.fused_render_fwd, *chip_smoke.main_path_fwd_x_args(
        trainer, test.poses[0], device))
    bw, cot = chip_smoke.main_path_render_bwd_args(trainer, device)
    add("render_bwd_d96", lambda *a, **k: flat(tk.fused_render_bwd(*a, **k)), *bw, *cot)
    for name, inline_pe in (("train_pe_d96", True), ("train_x_d96", False)):
        a, o = chip_smoke.main_path_train_args(trainer, last, device, inline_pe=inline_pe)
        add(name, lambda *a, **o: flat(tt.fused_train_objective(*a, **o)), *a, **o)
    a = chip_smoke.random_fwd_pe_args(rng, 1024, 64, 256, 8, 64, device, pos_freq=12, d_pad=176)
    add("fwd_pe_d176", tk.fused_render_fwd_pe, *a, use_feats=True)
    a, _ = chip_smoke.random_render_args(rng, 2048, 64, 256, 8, device, feat_dim=64, pos_freq=12)
    add("fwd_d176", tk.fused_render_fwd, *a)
    a, _ = chip_smoke.random_render_args(rng, 512, 64, 256, 8, device, feat_dim=64, pos_freq=12)
    add("render_bwd_d176", lambda *a, **k: flat(tk.fused_render_bwd(*a, **k)), *a,
        *chip_smoke.random_cotangents(rng, 512, 64, device))
    for name, inline_pe in (("train_pe_d176", True), ("train_x_d176", False)):
        a, o = chip_smoke.random_train_args(rng, 512, 64, 256, 8, device, feat_dim=64,
                                            pos_freq=12, inline_pe=inline_pe)
        add(name, lambda *a, **o: flat(tt.fused_train_objective(*a, **o)), *a, **o)

    rng = np.random.default_rng(1)
    a = chip_smoke.random_fwd_pe_args(rng, 1024, 64, 128, 3, 64, device, d_pad=160)
    add("fwd_pe_h128", tk.fused_render_fwd_pe, *a, use_feats=True)
    a, _ = chip_smoke.random_render_args(rng, 1024, 64, 128, 3, device, feat_dim=64)
    add("fwd_h128", tk.fused_render_fwd, *a)
    a, _ = chip_smoke.random_render_args(rng, 512, 64, 128, 3, device, feat_dim=64)
    add("render_bwd_h128", lambda *a, **k: flat(tk.fused_render_bwd(*a, **k)), *a,
        *chip_smoke.random_cotangents(rng, 512, 64, device))
    for name, inline_pe in (("train_pe_h128", True), ("train_x_h128", False)):
        a, o = chip_smoke.random_train_args(rng, 512, 64, 128, 3, device, feat_dim=64,
                                            white_bkgd=True, ragged=9, inline_pe=inline_pe)
        add(name, lambda *a, **o: flat(tt.fused_train_objective(*a, **o)), *a, **o)

    for seed, H in ((2, 384), (3, 512)):
        rng = np.random.default_rng(seed)
        a = chip_smoke.random_fwd_pe_args(rng, 512, 64, H, 3, 64, device, d_pad=160)
        add(f"fwd_pe_h{H}", tk.fused_render_fwd_pe, *a, use_feats=True)
        a, _ = chip_smoke.random_render_args(rng, 512, 64, H, 3, device, feat_dim=64)
        add(f"fwd_h{H}", tk.fused_render_fwd, *a)
        add(f"render_bwd_h{H}", lambda *a, **k: flat(tk.fused_render_bwd(*a, **k)), *a,
            *chip_smoke.random_cotangents(rng, 512, 64, device))
        for name, inline_pe in ((f"train_pe_h{H}", True), (f"train_x_h{H}", False)):
            a, o = chip_smoke.random_train_args(rng, 512, 64, H, 3, device, feat_dim=64,
                                                white_bkgd=True, ragged=9, inline_pe=inline_pe)
            add(name, lambda *a, **o: flat(tt.fused_train_objective(*a, **o)), *a, **o)

    if inputs:
        saved = torch.load(inputs)["args"]
        for name, (fn, _, _, _) in list(calls.items()):
            args, kw = _map(lambda t: t.to(device), saved[name])
            add(name, fn, *args, **kw)
    outputs, digests = {}, {}
    for name, (fn, args, kw, digest) in calls.items():
        for cd in ROUTES:
            got = fn(*args, **{**kw, "compute_dtype": cd})
            outputs[f"{name}_{cd}"] = [t.detach().cpu() for t in got if t is not None]
            digests[f"{name}_{cd}"] = digest
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    saved_args = {name: _map(lambda t: t.detach().cpu(), (args, kw))
                  for name, (_, args, kw, _) in calls.items()}
    torch.save({"root": root, "device": torch.cuda.get_device_name(0), "inputs": digests,
                "outputs": outputs, "args": saved_args}, out)
    print(f"route_bits: {len(outputs)} calls from {root} -> {out}", flush=True)
    print_registers(cuda_build.load("train_pe")[1].compiler_log)


def compare(a_path: str, b_path: str, reordered=()) -> bool:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    ok = True
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts])
    for name in a["outputs"]:
        same_in = a["inputs"][name] == b["inputs"].get(name)
        x, y = a["outputs"][name], b["outputs"][name]
        same = same_in and all(torch.equal(p, q) for p, q in zip(x, y))
        if name.startswith(tuple(reordered)):
            rel = ((flat(y) - flat(x)).norm() / flat(x).norm()).item()
            ok &= same_in
            print(f"  {name}: inputs {'equal' if same_in else 'DIFFER'}, outputs "
                  f"{'bit-equal' if same else 'differ'} (sums reordered by design), rel "
                  f"{rel:.3e}", flush=True)
            continue
        ok &= same
        print(f"  {name}: inputs {'equal' if same_in else 'DIFFER'}, outputs "
              f"{'bit-equal' if same else 'DIFFER'}", flush=True)
    if set(a["outputs"]) != set(b["outputs"]):
        print(f"  the files hold different calls: {sorted(set(a['outputs']) ^ set(b['outputs']))}",
              flush=True)
        ok = False
    return ok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--reordered", nargs="*", default=())
    ap.add_argument("--inputs", help="take the calls' inputs from this earlier run's file")
    args = ap.parse_args()
    if args.compare:
        if not compare(*args.compare, reordered=args.reordered):
            raise SystemExit("route_bits: the outputs differ")
    elif not args.out:
        ap.error("a run needs --out")
    else:
        run(args.root, args.out, args.inputs)


if __name__ == "__main__":
    main()
