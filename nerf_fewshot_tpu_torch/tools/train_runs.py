"""Train the baseline at the smoke's depth with one seed, from a given
checkout, and print its final loss, PSNR, step and eval times and a traced
phase-2 epoch as one JSON line (optionally the DINO and trunk-LoRA
configs' too); or summarize such lines as pairs of two checkouts; or
compare two runs' losses, parameters and eval view bit for bit.

    python nerf_fewshot_tpu_torch/tools/train_runs.py --root DIR --seed S --tag T --out FILE \
        [--bits FILE.pt] [--configs baseline dino_nerf lora_trunk script_lora]
    python nerf_fewshot_tpu_torch/tools/train_runs.py --summarize FILE --base T1 --change T2
    python nerf_fewshot_tpu_torch/tools/train_runs.py --compare-bits A.pt B.pt

A run imports ``nerf_fewshot_tpu_torch`` and ``chip_smoke`` from ``--root``
(so one copy of this script drives the port of any checkout that has
them), builds ``experiments/baseline.yaml`` (``chip_smoke.BASELINE_CONFIG``)
with ``seed: S`` on the synthetic lego-like scene at 128x128 (5 train, 8
test views, the scene's own seed 0), and trains it through the kernel on
the card over the smoke's epochs (0, 1, 50, 100-103: 670 steps of 1024x32,
1024x48 and 512x64 rays x samples). It appends to ``--out``: the PSNR at
init and after, the last epoch's mean and last step losses, the
milliseconds per step of epochs 101-103 (phase 2, untraced, each epoch
synchronized), the milliseconds per view of a ``render_views`` call of the
8 test views (after a first call), and epoch 104 traced (``trace``: the
device's busy share of the wall, stream synchronizations, device events
and launches per step, and, traced with the CPU activity, the host's
milliseconds per step by part; Adam's device ms a step, and the trainer's
CUDA graph captures with their costs). ``--bits`` saves every epoch's per-step
losses, the parameters after epoch 103 and test view 0 rendered then, and
the same of each ``--configs`` entry (after its epoch 102);
``--compare-bits`` compares them all.
``--configs`` adds ``experiments/dino_nerf.yaml``,
``experiments/lora_nerf_trunk.yaml`` and ``experiments/script_lora.yaml``
(the LoRA ones with ``sigma_bias: 0.1``, the smoke's live start), each on
its feature maps from the card (ViT-B/14; the script's patch embedding),
trained at epochs 0, 100, 101 and 102 (the phase-2 steps of 101-102
timed), an eval of the 8 test views timed and traced (busy share,
device events and launches per view, device ms by part), and epoch 103
traced. The trace is this script's checkout's
``chip_smoke.trace``, the same for both trees. Run the two checkouts
alternately, in separate processes (they share the package's name), A B B
A ...; ``--summarize`` pairs the i-th run of ``--base`` with the i-th of
``--change`` and prints each pair and the mean and standard deviation of
the differences, and each tree's mean trace.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

EPOCHS = (0, 1, 50, 100, 101, 102, 103)
TIMED = (101, 102, 103)
TRACED = 104
OTHER_EPOCHS, OTHER_TIMED, OTHER_TRACED = (0, 100, 101, 102), (101, 102), 103
CONFIGS = ("baseline", "dino_nerf", "lora_trunk", "script_lora")
FILES = {"dino_nerf": "dino_nerf.yaml", "lora_trunk": "lora_nerf_trunk.yaml",
         "script_lora": "script_lora.yaml"}
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tool_smoke():
    """This script's own checkout's ``chip_smoke`` (for ``trace``), loaded
    under another name beside the ``--root`` one."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_the_tool",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed_epochs(tr, epochs, timed):
    """Train ``epochs``; returns each epoch's mean loss and the ms per step
    of the ``timed`` ones (each synchronized)."""
    import numpy as np
    import torch

    ms, losses, steps = {}, {}, {}
    for e in epochs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[e] = tr.train_epoch(e)
        torch.cuda.synchronize()
        ms[e] = (time.perf_counter() - t0) / len(tr.last_step_losses) * 1e3
        steps[e] = tr.last_step_losses.copy()
        if not np.isfinite(tr.last_step_losses).all():
            raise RuntimeError(f"epoch {e}: non-finite losses")
    return losses, {e: ms[e] for e in timed}, steps


def _traced(smoke, tr, epoch):
    """``epoch`` traced with the CUDA activity only, then the next with the
    CPU activity too: the numbers per step a pair compares."""
    untraced = smoke.trace_epoch(tr, epoch, False)
    cpu = smoke.trace_epoch(tr, epoch + 1, True)
    return {"ms_per_step_traced": untraced["wall_ms"] / untraced["steps"],
            "busy_share": untraced["busy_ms"] / untraced["wall_ms"],
            "syncs_per_step": untraced["syncs"], "syncs_per_epoch": untraced["syncs_total"],
            "events_per_step": untraced["events"], "launches_per_step": untraced["launches"],
            "device_ms_per_step": sum(untraced["parts"].values()),
            # by part: this checkout's chip_smoke.KERNEL_GROUPS name the
            # hand-written kernels (the feature sampler's "point_features"),
            # the rest is "other"
            "device_ms_by_part": untraced["parts"],
            "adam_device_ms_per_step": (cpu["parts"].get("adam", 0.0)
                                        + cpu["parts"].get("adam_step", 0.0)),
            "host_ms_per_step": cpu["host"],
            "captures": getattr(tr, "graph_captures", [])}


def _other(root, name, train, test, device, smoke):
    """``dino_nerf``, ``lora_trunk`` or ``script_lora``: ms per phase-2 step
    and the trace; and its bits (per-step losses, parameters, test view 0
    after the timed epochs)."""
    import numpy as np

    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = load_config(os.path.join(root, "experiments", FILES[name]))
    if name != "dino_nerf":
        cfg = config_from_dict({**cfg.raw, "nerf_model": {**cfg.raw["nerf_model"],
                                                          "sigma_bias": 0.1}})
    feats = _precompute_features(cfg, train, device)
    tr = Trainer(cfg, train, test, device=device, dino_features=feats)
    if not tr._use_fused():
        raise RuntimeError(f"{name} must train through the kernel")
    for i in range(len(cfg.phases)):
        tr.phase_data(i)
    losses, ms, steps = _timed_epochs(tr, OTHER_EPOCHS, OTHER_TIMED)
    bits = _bits(tr, steps, test)
    return {"loss_last_epoch": losses[OTHER_EPOCHS[-1]],
            "ms_per_step": {str(e): v for e, v in ms.items()},
            "ms_per_step_mean": float(np.mean(list(ms.values()))),
            **_eval_times(smoke, tr, test),
            "trace": _traced(smoke, tr, OTHER_TRACED)}, bits


def _bits(tr, steps, test):
    """The per-step losses ``steps``, the trainer's parameters and test view
    0 rendered now, on the host."""
    return {"steps": steps, "view": tr.render_views([test.poses[0]]),
            "params": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}}


def _eval_times(smoke, tr, test):
    """ms per view of a ``render_views`` call of the 8 test views (after a
    first call), and the same call traced: the device's busy share, its
    events and the host's launches per view, device ms per view by part."""
    import torch

    tr.render_views(test.poses)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.render_views(test.poses)
    ms = (time.perf_counter() - t0) / len(test.poses) * 1e3
    t = smoke.trace(lambda: len([tr.render_views(test.poses)]) * len(test.poses), False)
    return {"eval_ms_per_view": ms, "eval_trace": {
        "busy_share": t["busy_ms"] / t["wall_ms"], "events_per_view": t["events"],
        "launches_per_view": t["launches"], "device_ms_by_part": t["parts"]}}


def run(root: str, seed: int, tag: str, out: str, bits: str = None,
        configs=("baseline",)) -> dict:
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
    torch.backends.cudnn.allow_tf32 = False
    smoke = _tool_smoke()
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
    losses, ms, steps = _timed_epochs(tr, EPOCHS, TIMED)
    saved = _bits(tr, steps, test)
    tr.render_views(test.poses)  # first use of this shape's buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.render_views(test.poses)
    eval_ms = (time.perf_counter() - t0) / len(test.poses) * 1e3
    rec = {"tag": tag, "root": root, "seed": seed, "psnr_init": psnr0,
           "psnr": tr.evaluate()["psnr"], "loss_last_epoch": losses[EPOCHS[-1]],
           "loss_last_step": float(tr.last_step_losses[-1]),
           "ms_per_step": {str(e): ms[e] for e in TIMED},
           "ms_per_step_mean": float(np.mean([ms[e] for e in TIMED])),
           "eval_ms_per_view": eval_ms, "trace": _traced(smoke, tr, TRACED)}
    saved["configs"] = {}
    for name in configs:
        if name != "baseline":
            rec[name], saved["configs"][name] = _other(root, name, train, test, device, smoke)
    if bits:
        torch.save(saved, bits)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


def _differ(x, y, label):
    """What of two runs' bits (``_bits``) differs, named under ``label``."""
    import numpy as np
    import torch

    if sorted(x["steps"]) != sorted(y["steps"]) or sorted(x["params"]) != sorted(y["params"]):
        return [f"{label}: different epochs or parameters"]
    bad = [f"{label} epoch {e} losses" for e in x["steps"]
           if not np.array_equal(x["steps"][e].view(np.int32), y["steps"][e].view(np.int32))]
    bad += [f"{label} parameter {k}" for k in x["params"]
            if not torch.equal(x["params"][k].view(torch.int32), y["params"][k].view(torch.int32))]
    bad += [f"{label} view output {i}" for i, (p, q) in enumerate(zip(x["view"], y["view"]))
            if not np.array_equal(p.view(np.int32), q.view(np.int32))]
    return bad


def compare_bits(a: str, b: str) -> None:
    """Raise unless two ``--bits`` files hold the same per-step losses,
    parameters and view, bit for bit, of the baseline and of every config
    both ran."""
    import torch

    x, y = torch.load(a, weights_only=False), torch.load(b, weights_only=False)
    runs = {"baseline": (x, y), **{n: (x["configs"][n], y["configs"][n])
                                   for n in x.get("configs", {}) if n in y.get("configs", {})}}
    bad = [d for n, (p, q) in runs.items() for d in _differ(p, q, n)]
    if bad:
        raise SystemExit(f"{a} vs {b}: not bit-equal: {', '.join(bad)}")
    for n, (p, _) in runs.items():
        print(f"{a} vs {b}: {n}: the per-step losses of "
              f"{sum(len(s) for s in p['steps'].values())} steps over epochs "
              f"{sorted(p['steps'])}, all {len(p['params'])} parameters and test view 0's rgb, "
              f"depth and acc bit-equal", flush=True)


def _mean_trace(recs, key=None):
    import numpy as np

    traces = [(r if key is None else r[key])["trace"] for r in recs]
    out = {k: float(np.mean([t[k] for t in traces])) for k in traces[0]
           if k not in ("host_ms_per_step", "captures", "device_ms_by_part")}
    parts = sorted({p for t in traces for p in t.get("device_ms_by_part", {})})
    out["device_ms_by_part"] = {p: float(np.mean([t["device_ms_by_part"].get(p, 0.0)
                                                  for t in traces])) for p in parts}
    if traces[0].get("captures"):
        out["captures"] = traces[0]["captures"]
    out["host_ms_per_step"] = {k: float(np.mean([t["host_ms_per_step"][k] for t in traces]))
                               for k in traces[0]["host_ms_per_step"]}
    return out


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
    keys = [(None, k) for k in ("psnr", "loss_last_epoch", "ms_per_step_mean", "eval_ms_per_view")
            if k in a[0]]
    keys += [(c, k) for c in CONFIGS[1:] if c in a[0] and c in b[0]
             for k in ("ms_per_step_mean", "eval_ms_per_view") if k in a[0][c] and k in b[0][c]]
    for cfg, key in keys:
        get = (lambda r: r[key]) if cfg is None else (lambda r: r[cfg][key])
        d = np.array([get(y) - get(x) for x, y in zip(a[:n], b[:n])])
        sd = float(d.std(ddof=1)) if n > 1 else float("nan")
        label = key if cfg is None else f"{cfg} {key}"
        print(f"  {label}: {base} mean {float(np.mean([get(x) for x in a[:n]]))!r}, {change} mean "
              f"{float(np.mean([get(y) for y in b[:n]]))!r}; difference mean {float(d.mean())!r}, "
              f"sd {sd!r}, {int((d > 0).sum())} of {n} above 0")
    for cfg in (None,) + CONFIGS[1:]:
        if "trace" not in a[0] or (cfg is not None and cfg not in a[0]):
            continue
        for tag, rs in ((base, a[:n]), (change, b[:n])):
            print(f"  trace {cfg or 'baseline'} {tag}: {json.dumps(_mean_trace(rs, cfg))}")
            if cfg is not None and "eval_trace" in rs[0][cfg]:
                print(f"  eval trace {cfg} {tag}: {json.dumps(rs[0][cfg]['eval_trace'])}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", help="the JSON-lines file a run appends to")
    ap.add_argument("--bits", help="a run saves its losses, parameters and view here")
    ap.add_argument("--configs", nargs="+", default=["baseline"], choices=CONFIGS)
    ap.add_argument("--summarize")
    ap.add_argument("--base")
    ap.add_argument("--change")
    ap.add_argument("--compare-bits", nargs=2)
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize, args.base, args.change)
    elif args.compare_bits:
        compare_bits(*args.compare_bits)
    elif not args.out:
        ap.error("a run needs --out")
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        run(args.root, args.seed, args.tag, args.out, args.bits, args.configs)


if __name__ == "__main__":
    main()
