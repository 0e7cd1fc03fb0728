#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``nerf_fewshot_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc. Phases, each printed with
its seconds:

1. device: the card's name, capability and ``nvidia-smi`` power limit;
2. build: nvcc builds every kernel of the paths (``csrc/fwd_pe.cu``,
   ``csrc/train_pe.cu``), one process per source, all started together, and
   prints ptxas' register and shared-memory lines;
3. kernel vs plain: the inline-PE render kernel against its plain PyTorch
   version on the card, at the main path's shape (2048 rays x 64 samples,
   8x256 trunk, the baseline's random init from its seed) and at
   S = 48 / 192, white background and 64-wide point features; CUDA-event
   times of both at the main path's shape;
4. train kernel vs plain: the training-objective kernel (loss and all six
   packed gradients) against its plain version at the three phase shapes
   of the schedule (1024x32, 1024x48, 512x64 rays x samples, 8x256, the
   baseline's init, inline PE); at 512x64 with a white background, a masked
   tail, the w^2 and depth terms and 64-wide features; the pre-encoded-x
   build (kernel 5); sigma_bias 5.0. CUDA-event times of the kernel and the
   plain version at each phase shape;
5. slice: ``experiments/baseline.yaml`` (as a literal dict) on the
   synthetic lego-like scene at 128x128 (5 train, 8 test views):
   ``Trainer(device="cuda").evaluate()``, whose chunks must each launch the
   kernel once, checked against the plain pipeline on the card;
6. train slice: the same trainer trains through the kernel for one epoch
   of each phase plus one more at 32x32 and at 128x128 (``train_epoch`` at
   epochs 0, 1, 50, 100, 101), then ``fit`` two more epochs with eval, PNG dumps and
   checkpoints into a temporary directory; every step must launch the
   kernel once, PSNR must rise above its value at init, and a trainer on
   the plain path (``backend: xla``) from the same seed must give the same
   per-step losses over epoch 0;
7. train step breakdown: one phase-2 epoch untraced, then under
   ``torch.profiler`` with the CUDA activity only (the device's busy share
   of the epoch, the stream synchronizations per step) and with the CPU
   activity too (device time per step by part: the kernel's launches,
   Adam, the rest).

Any failure raises and exits non-zero. On success the last three lines are
the ``nvidia-smi`` name/power-limit line, a JSON line with the kernels'
numbers, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

import nerf_fewshot_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

# experiments/baseline.yaml, parsed (a CPU test holds the two equal): the
# card machine has no yaml.
BASELINE_CONFIG = {
    "experiment": {"name": "NeRF-Baseline-Lego"},
    "data": {"dataset": "nerf_synthetic", "scene": "lego", "num_views": 5,
             "resolution": 128, "near": 2.0, "far": 6.0},
    "model": {"use_dino": False},
    "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 256, "num_layers": 8,
                   "sigma_bias": 0.1},
    "dino_model": {"name": "facebook/dinov2-base", "use_lora": False, "lora_rank": 4,
                   "lora_alpha": 4},
    "training": {"epochs": 200, "batch_size": 1024,
                 "progressive_schedule": {"epochs_0_50": [32, 32, 32],
                                          "epochs_50_100": [64, 64, 48],
                                          "epochs_100_plus": [128, 128, 64]}},
    "optimizer": {"lr": 0.0005, "weight_decay": 1e-06, "lr_milestones": [100, 150],
                  "lr_gamma": 0.5},
    "loss": {"rgb_weight": 1.0, "depth_weight": 0.0, "reg_weight": 0.0},
    "rendering": {"near": 2.0, "far": 6.0, "chunk_size": 2048, "noise_std": 0.0,
                  "white_bkgd": False, "backend": "auto"},
    "output": {"save_dir": "results/baseline_lego", "val_freq": 10, "save_freq": 50},
}

# H100 SXM published peaks (dense): FP32 on the CUDA cores, HBM3 bandwidth.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain: fp32 sums in another order (the kernel: k-ordered FMAs;
# cuBLAS: its blocked order); depth sums w*z with z up to 6.
TOL = {"rgb": 1e-4, "depth": 1e-3, "acc": 1e-4, "weights": 1e-4}
# Train kernel vs plain: loss rel 1e-5; the six packed gradients as one
# vector rel 1e-4, and 2e-2 at sigma_bias 5.0, where the backward divides by
# transmittances at the 1e-10 floor (the JAX gate, render/verify.py).
TRAIN_GRAD_TOL, TRAIN_GRAD_TOL_SATURATED = 1e-4, 2e-2
# Kernel trainer vs plain trainer, per-step losses of epoch 0.
TRAIN_LOSS_RTOL = 1e-4
N_TEST_VIEWS, N_TRAIN_VIEWS = 8, 5
KERNELS = ("fwd_pe", "train_pe")
# one epoch of each phase and one more at 32x32 and at 128x128: the first
# epoch's steps include the first use (module loading) of every CUDA kernel
TRAIN_EPOCHS = (0, 1, 50, 100, 101)


@contextmanager
def phase(name):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean CUDA-event time of ``fn()`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fwd_pe_cost(args, use_feats):
    """(FLOPs, bytes) the function needs on these inputs: the trunk and head
    products over the unpadded input width, each input read once, each
    output written once."""
    raw, feats, z, dnorm, e2, c, packed = args
    w0, b0, wh, bh, wout, bout = packed
    n_points = raw.shape[0]
    H, L1 = w0.shape[1], wh.shape[0]
    x_dim = raw.shape[1] + e2.shape[1] + (feats.shape[1] if use_feats else 0)
    flops = 2.0 * n_points * (x_dim * H + L1 * H * H + H * 4)
    inputs = [raw, z, dnorm, e2, c, *packed] + ([feats] if use_feats else [])
    R, S = z.shape
    out_elems = R * 3 + R + R + R * S
    nbytes = 4.0 * (sum(t.numel() for t in inputs) + out_elems)
    return flops, nbytes


def random_fwd_pe_args(rng, R, S, H, L, feat_dim, device):
    """Random inputs of the given shape: torch-default-bounded weights,
    points in the scene box, depths in [2, 6]."""
    from nerf_fewshot_tpu_torch.render import kernels as tk

    perm, e2, c, x_dim = tk.pe_layout(10, 4, True, feat_dim)

    def u(fan_in, *shape):
        return torch.tensor((rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32))

    state = {"trunk.0.weight": u(x_dim, H, x_dim), "trunk.0.bias": u(x_dim, H)}
    for i in range(1, L):
        state[f"trunk.{i}.weight"] = u(H, H, H)
        state[f"trunk.{i}.bias"] = u(H, H)
    state.update({"rgb_head.weight": u(H, 3, H), "rgb_head.bias": u(H, 3),
                  "sigma_head.weight": u(H, 1, H), "sigma_head.bias": torch.full((1,), 0.1)})
    packed = tk.pack_params(state, L, H, d_pad=-(-x_dim // 128) * 128, row_perm=perm)
    pts = torch.tensor(rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32))
    rd = torch.tensor(rng.standard_normal((R, 3)).astype(np.float32))
    z = torch.tensor(np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32))
    feats = (torch.tensor(rng.standard_normal((R * S, feat_dim)).astype(np.float32))
             if feat_dim else None)
    on = lambda t: None if t is None else t.to(device)
    return (on(tk._raw_block(pts, rd, True)), on(feats), on(z),
            on(torch.linalg.norm(rd, dim=-1, keepdim=True)), on(torch.tensor(e2)),
            on(torch.tensor(c)), tuple(p.to(device) for p in packed))


def random_state(rng, x_dim, H, L, sigma_bias):
    """A NeRFMLP state dict with torch-default-bounded random weights and a
    constant sigma-head bias."""
    def u(fan_in, *shape):
        return torch.tensor((rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32))

    state = {"trunk.0.weight": u(x_dim, H, x_dim), "trunk.0.bias": u(x_dim, H)}
    for i in range(1, L):
        state[f"trunk.{i}.weight"] = u(H, H, H)
        state[f"trunk.{i}.bias"] = u(H, H)
    state.update({"rgb_head.weight": u(H, 3, H), "rgb_head.bias": u(H, 3),
                  "sigma_head.weight": u(H, 1, H),
                  "sigma_head.bias": torch.full((1,), float(sigma_bias))})
    return state


def random_train_args(rng, R, S, H, L, device, *, feat_dim=0, sigma_bias=0.1,
                      white_bkgd=False, ragged=0, reg_weight=0.0, depth_weight=0.0,
                      inline_pe=True):
    """Random inputs of the train kernel as ``fused_train_loss_grad`` builds
    them: random weights (``random_state``), rays from (0, 0, 4) into the
    scene volume, jittered samples in [2, 6], uniform rgb targets, the last
    ``ragged`` rays masked out, depth targets in [2.5, 5.5] when
    ``depth_weight``, features ``tanh(pts @ W)`` when ``feat_dim``.
    Returns ``(args, opts)`` for ``fused_train_objective(*args, **opts)``."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

    state = {k: v.to(device) for k, v in random_state(rng, 90 + feat_dim, H, L, sigma_bias).items()}
    on = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    d = rng.standard_normal((R, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    mask = np.ones(R)
    mask[R - ragged:] = 0.0
    pf = None
    if feat_dim:
        W = on(rng.standard_normal((3, feat_dim)))
        pf = lambda pts: torch.tanh(pts @ W)
    settings = RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=True, white_bkgd=white_bkgd)
    return tt.train_objective_inputs(
        state, on(np.broadcast_to([0.0, 0.0, 4.0], (R, 3))), on(d), on(rng.uniform(0, 1, (R, 3))),
        on(mask), settings, 10, 4, L, H, uniforms=on(rng.uniform(0, 1, (R, S))),
        inline_pe=inline_pe, reg_weight=reg_weight, depth_weight=depth_weight,
        target_depth=on(rng.uniform(2.5, 5.5, R)) if depth_weight else None, point_features_fn=pf)


def train_cost(args, opts):
    """(FLOPs, bytes) the objective needs on these inputs: the forward trunk
    and head over the unpadded input width, the backward chain (head, then
    the hidden layers; no input gradient), the dW products; each input
    read once, each output written once."""
    inp, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed = args
    w0, b0, wh, bh, wout, bout = packed
    n_points = z.numel()
    H, L1 = w0.shape[1], wh.shape[0]
    if opts["inline_pe"]:
        x_dim = inp.shape[1] + e2.shape[1] + (0 if feats is None else feats.shape[1])
    else:
        x_dim = inp.shape[1]
    fwd = x_dim * H + L1 * H * H + H * 4
    bwd = H * 4 + L1 * H * H
    flops = 2.0 * n_points * (2 * fwd + bwd)
    inputs = [inp, z, dnorm, tgt, mask, inv_denom, *packed]
    inputs += [t for t in (feats, e2, c, opts["tgt_depth"]) if t is not None]
    nbytes = 4.0 * (sum(t.numel() for t in inputs) + 1 + sum(p.numel() for p in packed))
    return flops, nbytes


def compare_train(name, got, want, grad_tol):
    """Loss rel error (<= 1e-5) and the global grad rel error over all six
    packed grads (<= grad_tol); the grads must be alive (norm > 1e-6)."""
    (gl, gd), (wl, wd) = got, want
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts])
    g, w = flat(gd), flat(wd)
    if not (torch.isfinite(gl) and torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: kernel loss or grads are not finite")
    loss_rel = abs(gl.item() - wl.item()) / max(abs(wl.item()), 1e-12)
    norm = w.norm().item()
    grad_rel = (g - w).norm().item() / max(norm, 1e-30)
    max_err = max((a - b).abs().max().item() for a, b in zip(gd, wd))
    print(f"  {name}: loss {gl.item():.6e} rel err {loss_rel:.2e} (tol 1e-5), grad rel err "
          f"{grad_rel:.2e} (tol {grad_tol:.0e}), |g| {norm:.3e}, max abs err {max_err:.2e}",
          flush=True)
    if not (norm > 1e-6 and loss_rel <= 1e-5 and grad_rel <= grad_tol):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(loss rel {loss_rel}, grad rel {grad_rel}, |g| {norm})")
    return max_err


def main_path_train_args(trainer, phase_idx, device, inline_pe=True, seed=0):
    """One training step of the trainer at a phase's shape, as
    ``train_epoch`` builds it: a batch of train-view-0 rays, the phase's
    samples per ray with jitter uniforms, the trainer's weights."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt

    cfg = trainer.cfg
    p = cfg.phases[phase_idx]
    pd = trainer.phase_data(phase_idx)
    n_rays = pd.rays_o.shape[1]
    B = min(p.batch_size, n_rays)
    g = torch.Generator(device).manual_seed(seed)
    idx = torch.randperm(n_rays, generator=g, device=device)[:B]
    state = {k: v.detach() for k, v in trainer.model.named_parameters()}
    return tt.train_objective_inputs(
        state, pd.rays_o[0][idx], pd.rays_d[0][idx], pd.targets[0][idx],
        torch.ones(B, device=device), trainer._render_settings(p.n_samples, training=True),
        cfg.nerf.pos_freq, cfg.nerf.dir_freq, cfg.nerf.num_layers, cfg.nerf.hidden_dim,
        uniforms=torch.rand((B, p.n_samples), generator=g, device=device), inline_pe=inline_pe)


def trace_epoch(trainer, epoch, with_cpu):
    """One ``train_epoch`` under ``torch.profiler``. With the CUDA activity
    only (``with_cpu`` False) the host is slowed least: the device's busy
    time is the union of its kernel and copy intervals, set against the
    epoch's wall time, and the stream synchronizations the host made are
    counted. With the CPU activity too, Adam's device time is read from the
    optimizer's own ``Optimizer.step#...`` range. Device-side spans of
    annotated ranges are not kernels and are left out. Returns the wall ms,
    the busy ms, and per step: device ms by part (the training kernel's
    launches by name, ``adam`` with the CPU activity, ``other``: gather,
    sampling, ``pack_params`` and its backward, copies), device events and
    stream synchronizations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    trainer.phase_data(trainer._phase_index(epoch))
    torch.cuda.synchronize()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = len(trainer.last_step_losses)
    parts, spans, adam, syncs = {}, [], 0.0, 0
    for evt in prof.events():
        if evt.name == "cudaStreamSynchronize":
            syncs += 1
        if evt.name.startswith("Optimizer.step#"):
            if evt.device_type == DeviceType.CPU:
                adam += evt.device_time_total / 1e3
            continue
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        group = next((g for g in ("train_fwd", "train_bwd", "train_dw", "train_composite",
                                  "train_finalize", "loss_sum", "wh_transpose") if g in evt.name),
                     "other")
        parts[group] = parts.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    if with_cpu:
        parts["other"] = parts.get("other", 0.0) - adam
        parts["adam"] = adam
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3,
                parts={k: v / steps for k, v in parts.items()},
                events=len(spans) / steps, syncs=syncs / steps, steps=steps)


def main_path_fwd_pe_args(trainer, pose, device):
    """The first 2048-ray chunk of a 128x128 test view, exactly as
    ``fused_render_rays`` hands it to the kernel, with the trainer's
    weights."""
    from nerf_fewshot_tpu_torch.ops.rays import get_rays
    from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
    from nerf_fewshot_tpu_torch.render import kernels as tk

    cfg = trainer.cfg
    ro, rd = get_rays(trainer.H, trainer.W, trainer.focal,
                      torch.as_tensor(pose, dtype=torch.float32, device=device))
    chunk = cfg.rendering.chunk_size
    ro, rd = ro.reshape(-1, 3)[:chunk], rd.reshape(-1, 3)[:chunk]
    pts, z = sample_along_rays(ro, rd, cfg.rendering.near, cfg.rendering.far,
                               cfg.phases[-1].n_samples)
    perm, e2, c, x_dim = tk.pe_layout(cfg.nerf.pos_freq, cfg.nerf.dir_freq, True, 0)
    packed = tk.pack_params(trainer.model.state_dict(), cfg.nerf.num_layers,
                            cfg.nerf.hidden_dim, d_pad=-(-x_dim // 128) * 128, row_perm=perm)
    return (tk._raw_block(pts, rd, True), None, z.contiguous(),
            torch.linalg.norm(rd, dim=-1, keepdim=True),
            torch.as_tensor(e2, device=device), torch.as_tensor(c, device=device), packed)


def compare(name, got, want):
    """Max abs error of each output; raises past its tolerance."""
    errs = {}
    for g, w, out in zip(got, want, ("rgb", "depth", "acc", "weights")):
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: kernel {out} is not finite")
        errs[out] = (g - w).abs().max().item()
    print(f"  {name}: max abs err " + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:.0e})"
                                                  for k, v in errs.items()), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= TOL[k]}
    if bad:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version: {bad}")
    return max(errs.values())


def run_train_slice(cfg, train, test, device, tmp, psnr_init, tt):
    """Train the baseline through the kernel (``train_epoch`` at
    ``TRAIN_EPOCHS``, then ``fit`` for two more epochs with eval and
    checkpoints into ``tmp``), check it against a plain-path trainer from
    the same seed, and return the launches of (train_pe, train_x)."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    out = {**BASELINE_CONFIG["output"], "save_dir": tmp, "val_freq": 2, "save_freq": 2}
    kcfg = config_from_dict({**BASELINE_CONFIG, "output": out})
    pcfg = config_from_dict({**BASELINE_CONFIG, "output": out, "rendering": {
        **BASELINE_CONFIG["rendering"], "backend": "xla"}})
    ktr = Trainer(kcfg, train, test, device=device, log_path=os.path.join(tmp, "log.jsonl"))
    ptr = Trainer(pcfg, train, test, device=device)
    if not ktr._use_fused() or ptr._use_fused():
        raise RuntimeError("backend auto must train through the kernel, xla on the plain path")
    psnr0 = ktr.evaluate()["psnr"]
    if abs(psnr0 - psnr_init) > 1e-3:
        raise RuntimeError(f"psnr at init {psnr0} vs the eval slice's {psnr_init}")
    for i in range(len(cfg.phases)):  # set-up, kept out of the epoch times
        ktr.phase_data(i)
        ptr.phase_data(i)

    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    steps, kernel_losses = 0, {}
    for e in TRAIN_EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ktr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = len(ktr.last_step_losses)
        steps += n
        kernel_losses[e] = ktr.last_step_losses.copy()
        pd = ktr.phase_data(ktr._phase_index(e))
        rays = ktr.n_views * pd.rays_o.shape[1]
        print(f"  kernel trainer epoch {e} ({pd.H}x{pd.W}, "
              f"{cfg.phase_for_epoch(e).n_samples} samples): loss {loss:.6f}, {n} steps, "
              f"{sec:.3f} s, {sec / n * 1e3:.3f} ms/step, {rays / sec:.0f} rays/s", flush=True)
        if not np.isfinite(ktr.last_step_losses).all():
            raise RuntimeError(f"epoch {e}: non-finite losses {ktr.last_step_losses}")
    ktr.epoch = TRAIN_EPOCHS[-1] + 1
    t0 = time.perf_counter()
    after = ktr.fit(ktr.epoch + 2)
    fit_steps = 2 * len(ktr.last_step_losses)
    steps += fit_steps
    print(f"  fit epochs {ktr.epoch - 1}-{ktr.epoch}: {fit_steps} steps, eval, "
          f"{time.perf_counter() - t0:.3f} s; psnr {psnr0:.4f} dB at init, "
          f"{after['psnr']:.4f} dB after, ssim {after['ssim']:.5f}", flush=True)
    counts = dict(tt.fused_train_objective.launches)
    print(f"  launches: {counts} for {steps} steps", flush=True)
    if counts["train_pe"] != steps:
        raise RuntimeError(f"{counts['train_pe']} train kernel launches for {steps} steps")
    probe = ktr.dead_sigma_probe()
    if not probe > 0.0:
        raise RuntimeError(f"dead-sigma probe {probe}")
    if not after["psnr"] > psnr0:
        raise RuntimeError(f"psnr after training {after['psnr']} <= at init {psnr0}")
    for name in ("best.ckpt", f"epoch_{ktr.epoch + 1}.ckpt",
                 os.path.join(f"epoch_{ktr.epoch}", "render_0.png")):
        if not os.path.exists(os.path.join(tmp, name)):
            raise RuntimeError(f"fit wrote no {name}")
    restored = Trainer(kcfg, train, test, device=device)
    restored.load(os.path.join(tmp, f"epoch_{ktr.epoch + 1}.ckpt"))
    for (k, a), b in zip(ktr.model.state_dict().items(), restored.model.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint round trip changed {k}")

    for e in TRAIN_EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ptr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        rel = np.abs(ptr.last_step_losses / kernel_losses[e] - 1.0)
        mean_rel = abs(loss / float(np.mean(kernel_losses[e])) - 1.0)
        print(f"  plain trainer epoch {e}: loss {loss:.6f}, {sec:.3f} s, "
              f"{sec / len(rel) * 1e3:.3f} ms/step; gap to the kernel trainer: per step max rel "
              f"{rel.max():.2e}, epoch mean rel {mean_rel:.2e}", flush=True)
        if e == TRAIN_EPOCHS[0] and not rel.max() <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"epoch {e}: kernel and plain trainers differ by rel {rel.max()} "
                               f"(tol {TRAIN_LOSS_RTOL})")
    return counts["train_pe"], counts["train_x"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.render import cuda_build
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.metrics import psnr
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    device = torch.device("cuda", 0)
    # exact fp32 in the plain versions (TF32 would keep ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
              f"capability {cap}, {torch.cuda.device_count()} card(s)", flush=True)
        print(f"  nvidia-smi: {smi}", flush=True)
        if cap != (9, 0):
            raise RuntimeError(f"{kind} has capability {cap}; the kernels are built for sm_90a")

    with phase("build"):
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            infos = list(pool.map(cuda_build.build, KERNELS))
        for name, info in zip(KERNELS, infos):
            print(f"  {name}: {info.seconds:.2f} s -> {info.path}", flush=True)
            for line in info.compiler_log.splitlines():
                if "Used" in line or "Compiling entry" in line or "spill" in line:
                    print(f"  {line.strip()}", flush=True)

    cfg = config_from_dict(BASELINE_CONFIG)
    widths = (cfg.nerf.hidden_dim, cfg.nerf.num_layers, cfg.phases[-1].n_samples,
              cfg.rendering.chunk_size, cfg.data.resolution)
    if widths != (256, 8, 64, 2048, 128):
        raise RuntimeError(f"baseline widths {widths}")
    res = cfg.data.resolution

    with phase("scene"):
        scene = lego_like_scene()
        train = make_scene_dataset(scene, N_TRAIN_VIEWS, img_size=res, seed=cfg.seed,
                                   device=device)
        test = make_scene_dataset(scene, N_TEST_VIEWS, img_size=res, seed=cfg.seed,
                                  split="test", device=device)
        trainer = Trainer(cfg, train, test, device=device)
        print(f"  {train.n_views} train + {test.n_views} test views at {res}x{res}", flush=True)

    with phase("kernel vs plain"):
        args = main_path_fwd_pe_args(trainer, test.poses[0], device)
        max_err = compare("main path 2048x64, 8x256",
                          tk.fused_render_fwd_pe(*args), tk.fused_render_fwd_pe_reference(*args))
        rng = np.random.default_rng(cfg.seed)
        for S, white, fd in ((48, False, 0), (192, False, 0), (64, True, 0), (64, False, 64)):
            a = random_fwd_pe_args(rng, 2048, S, 256, 8, fd, device)
            kw = dict(white_bkgd=white, use_feats=fd > 0)
            compare(f"S={S} white_bkgd={white} Fd={fd}",
                    tk.fused_render_fwd_pe(*a, **kw), tk.fused_render_fwd_pe_reference(*a, **kw))
        torch.cuda.synchronize()
        kernel_ms = cuda_ms(lambda: tk.fused_render_fwd_pe(*args), iters=20)
        plain_ms = cuda_ms(lambda: tk.fused_render_fwd_pe_reference(*args), iters=10)
        flops, nbytes = fwd_pe_cost(args, use_feats=False)
        bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        print(f"  main path: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); kernel at {flops / kernel_ms / 1e9:.2f} TFLOP/s",
              flush=True)

    with phase("train kernel vs plain"):
        train_err = {"train_pe": 0.0, "train_x": 0.0}
        timing = {}
        for i in range(len(cfg.phases)):
            a, o = main_path_train_args(trainer, i, device)
            R, S = a[2].shape
            err = compare_train(f"phase {i} {R}x{S}, 8x256, baseline init",
                                tt.fused_train_objective(*a, **o),
                                tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
            train_err["train_pe"] = max(train_err["train_pe"], err)
            timing[("train_pe", i)] = (a, o)
        rng = np.random.default_rng(cfg.seed)
        full = dict(white_bkgd=True, ragged=9, reg_weight=0.01, depth_weight=0.1, feat_dim=64)
        for name, label, kw, tol in (
                ("train_pe", "512x64 white, 9 masked, reg, depth, Fd 64", full, TRAIN_GRAD_TOL),
                ("train_pe", "512x64 sigma_bias 5.0", dict(sigma_bias=5.0),
                 TRAIN_GRAD_TOL_SATURATED),
                ("train_x", "512x64 x input, white, 9 masked, reg, depth, Fd 64",
                 dict(full, inline_pe=False), TRAIN_GRAD_TOL)):
            a, o = random_train_args(rng, 512, 64, 256, 8, device, **kw)
            err = compare_train(label, tt.fused_train_objective(*a, **o),
                                tt.fused_train_objective_reference(*a, **o), tol)
            train_err[name] = max(train_err[name], err)
        a, o = main_path_train_args(trainer, len(cfg.phases) - 1, device, inline_pe=False)
        err = compare_train("512x64 x input (kernel 5), baseline init",
                            tt.fused_train_objective(*a, **o),
                            tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
        train_err["train_x"] = max(train_err["train_x"], err)
        timing[("train_x", len(cfg.phases) - 1)] = (a, o)
        torch.cuda.synchronize()
        train_ms = {}
        for (name, i), (a, o) in timing.items():
            k_ms = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=20)
            p_ms = cuda_ms(lambda: tt.fused_train_objective_reference(*a, **o), iters=5)
            flops, nbytes = train_cost(a, o)
            b_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            b_by = "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
            train_ms[(name, i)] = (k_ms, p_ms, b_ms, b_by)
            R, S = a[2].shape
            print(f"  {name} phase {i} {R}x{S}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms by {b_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB); "
                  f"kernel at {flops / k_ms / 1e9:.2f} TFLOP/s", flush=True)

    with phase("slice"):
        trainer.render_views(test.poses[:1])  # warm the host path
        tk.fused_render_fwd_pe.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.evaluate()
        seconds = time.perf_counter() - t0
        launches = tk.fused_render_fwd_pe.launches
        n_rays = N_TEST_VIEWS * res * res
        n_chunks = -(-n_rays // cfg.rendering.chunk_size)
        print(f"  evaluate: psnr {metrics['psnr']:.4f} dB, ssim {metrics['ssim']:.5f}, "
              f"{n_rays / seconds:.0f} rays/s, {seconds / N_TEST_VIEWS * 1e3:.2f} ms/view, "
              f"{launches} launches for {n_chunks} chunks", flush=True)
        if launches != n_chunks:
            raise RuntimeError(f"{launches} kernel launches for {n_chunks} chunks")
        if not (np.isfinite(metrics["psnr"]) and np.isfinite(metrics["ssim"])):
            raise RuntimeError(f"non-finite metrics {metrics}")

        # the same views on the plain pipeline (same seed, same weights)
        plain = Trainer(config_from_dict({**BASELINE_CONFIG, "rendering": {
            **BASELINE_CONFIG["rendering"], "backend": "xla"}}), train, test, device=device)
        if plain._use_fused():
            raise RuntimeError("backend: xla still selects the kernel")
        got = trainer.render_views(test.poses)
        want = plain.render_views(test.poses)
        errs = {}
        for g, w, out in zip(got, want, ("rgb", "depth", "acc")):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise RuntimeError(f"slice {out}: shape {g.shape} or non-finite values")
            errs[out] = float(np.abs(g - w).max())
        print("  views vs plain pipeline: max abs err " + ", ".join(
            f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
        bad = {k: v for k, v in errs.items() if not v <= TOL[k]}
        if bad:
            raise RuntimeError(f"kernel-rendered views disagree with the plain pipeline: {bad}")
        plain_psnr = float(np.mean([
            float(psnr(torch.as_tensor(want[0][i]), torch.as_tensor(test.images[i])))
            for i in range(N_TEST_VIEWS)]))
        if abs(plain_psnr - metrics["psnr"]) > 1e-3:
            raise RuntimeError(f"psnr {metrics['psnr']} vs plain {plain_psnr}")

    with phase("train slice"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            train_launches, x_launches = run_train_slice(
                cfg, train, test, device, tmp, metrics["psnr"], tt)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    with phase("train step breakdown"):
        epoch = TRAIN_EPOCHS[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(epoch)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        steps = len(trainer.last_step_losses)
        print(f"  epoch {epoch} untraced: wall {untraced_ms:.1f} ms, "
              f"{untraced_ms / steps:.3f} ms/step", flush=True)
        for with_cpu in (False, True):
            t = trace_epoch(trainer, epoch, with_cpu)
            if not t["busy_ms"] > 0:
                raise RuntimeError("the profiler recorded no device time")
            label = "CPU+CUDA" if with_cpu else "CUDA only"
            print(f"  epoch {epoch} traced ({label}): wall {t['wall_ms']:.1f} ms "
                  f"({t['wall_ms'] / untraced_ms:.3f}x untraced), device busy "
                  f"{t['busy_ms']:.1f} ms ({t['busy_ms'] / t['wall_ms']:.1%} of the traced wall), "
                  f"per step: "
                  f"{t['events']:.1f} device events, {t['syncs']:.2f} stream synchronizations, "
                  f"device ms " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(t["parts"].items(), key=lambda kv: -kv[1]))
                  + f", sum {sum(t['parts'].values()):.3f}", flush=True)

    last = len(cfg.phases) - 1

    def train_row(name, cu_line, launches):
        k_ms, p_ms, b_ms, b_by = train_ms[(name, last)]
        return {"name": name, "route": "cuda",
                "source": "nerf_fewshot_tpu_torch/csrc/train_pe.cu",
                "replaces": f"nerf_fewshot_tpu/render/train_kernel.py:{cu_line}",
                "launches": launches, "max_abs_err": train_err[name], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fwd_pe",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/fwd_pe.cu",
        "replaces": "nerf_fewshot_tpu/render/kernels.py:251",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, train_row("train_pe", 343, train_launches), train_row("train_x", 320, x_launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
