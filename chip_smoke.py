#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``nerf_fewshot_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc. Phases, each printed with
its seconds:

1. device: the card's name, capability and ``nvidia-smi`` power limit;
2. build: nvcc builds every kernel of the paths (``csrc/fwd_pe.cu``: kernels
   2 and 4; ``csrc/train_pe.cu``: kernels 1, 5 and 3), one process per
   source, all started together, and prints ptxas' register, shared-memory
   and spill lines;
3. kernel vs plain: the inline-PE render kernel (kernel 2: trunk products
   as 3xTF32 wgmma) against its plain PyTorch version on the card, at the
   main path's shape (2048 rays x 64 samples, 8x256 trunk, the baseline's
   random init from its seed), two calls bit for bit, and at S = 48 / 192,
   white background and 64-wide point features; CUDA-event times of both at
   the main path's shape, its bound, and the device time of each of its
   grid launches (weight split, trunk, composite);
4. train kernel vs plain: the training-objective kernel (loss and all six
   packed gradients) against its plain version at the three phase shapes
   of the schedule (1024x32, 1024x48, 512x64 rays x samples, 8x256, the
   baseline's init, inline PE); at 512x64 with a white background, a masked
   tail, the w^2 and depth terms and 64-wide features; the pre-encoded-x
   build (kernel 5); sigma_bias 5.0. CUDA-event times of the kernel and the
   plain version at each phase shape; the device time of each grid launch
   at 512x64 (``torch.profiler``); the error of the kernel and of the fp32
   plain version against a float64 run of the plain version from the same
   fp32 encoded input (a report);
5. render kernel 4 vs plain: the render from a pre-encoded x at the main
   path's shape (a 2048x64 eval chunk, x 128 wide, the baseline's init), two
   calls bit for bit, and at S = 128, white background, 64-wide features (x
   256 wide); times, bound and the device time of each grid launch;
6. render VJP kernel 3 vs plain: at 512x64 (the baseline's phase-2 batch,
   its init, standard-normal cotangents on all four outputs), two calls bit
   for bit, then a white background with 64-wide features, S = 128 and
   sigma_bias 5.0; dx and the six packed gradients as one vector; times,
   bound, each grid launch's device time and the float64 comparison;
7. differentiable render steps: the baseline ``NeRFMLP`` from its seed
   takes 30 Adam steps (512 rays x 64 samples of the 128x128 views, a loss
   on rgb, weights, depth and acc) through
   ``fused_render_rays(forward_only=False)`` and the same steps through the
   plain ``render_rays`` and autograd, then 15 hierarchical ones
   (n_importance 64); per-step losses must agree over the first 5 steps;
   every step launches kernels 4 and 3;
8. slice: ``experiments/baseline.yaml`` (as a literal dict) on the
   synthetic lego-like scene at 128x128 (5 train, 8 test views):
   ``Trainer(device="cuda").evaluate()``, whose chunks must each launch the
   kernel once, checked against the plain pipeline on the card;
9. train slice: the same trainer trains through the kernel for one epoch
   of each phase plus one more at 32x32 and at 128x128 (``train_epoch`` at
   epochs 0, 1, 50, 100, 101), then ``fit`` two more epochs with eval, PNG dumps and
   checkpoints into a temporary directory; every step must launch the
   kernel once, PSNR must rise above its value at init, and a trainer on
   the plain path (``backend: xla``) from the same seed must give the same
   per-step losses over epoch 0;
10. evaluate baseline.yaml: the trained trainer's checkpoint through
   ``cli evaluate --config experiments/baseline.yaml --synthetic`` in this
   process on the card: ``evaluation.json`` with the JAX harness's keys
   (PSNR, SSIM, LPIPS with ``lpips_pretrained: false`` and its backend, 8
   novel views, depth statistics of 3 views, both smoothness analyses) and
   its PNGs; kernel 2 once per chunk of each ``render_views`` stream (8
   test, 8 orbit, 3 depth views: 152 launches); the checkpoint through a
   ``backend: xla`` trainer's harness (orbit and depth views within the
   view tolerances, depth means within 1e-3, PSNR within 1e-3 dB); LPIPS
   of the 8 test views on the card against the CPU (rel 1e-4, cuDNN's TF32
   off; the reading with it on printed, not gated); ms per evaluated view
   (render and LPIPS apart), per orbit view, the call's wall time;
11. train step breakdown: one phase-2 epoch untraced, then under
   ``torch.profiler`` with the CUDA activity only (the device's busy share
   of the epoch, the stream synchronizations per step) and with the CPU
   activity too (device time per step by part: the kernel's launches,
   Adam, the rest);
12. hierarchical train slice: ``experiments/hierarchical.yaml`` (a literal
   dict) trains at the same epochs (every step: kernel 2 as the coarse
   pass, kernel 1 over the merged 96 / 112 / 128 samples), PSNR must rise;
   eval runs kernel 2 for both passes; kernel times at the step's shapes;
   one ``fused_train_loss_grad(inline_pe=False)`` step (kernel 4 as the
   coarse pass, kernel 5) against the inline-PE step;
13. repair check: ``experiments/smoke.yaml`` (width 64) trains a phase-0
   epoch on the plain path under ``backend: auto`` and says so in
   ``kernel_path``; under ``fused`` it raises, and width 384 raises too;
14. DINO kernel widths: kernel 1 at 512x64 and kernel 2 at a 1024x64 eval
   chunk, pos_freq 12, with 64 and 128 features (inputs padded to D 176
   and 240), against their plain versions; times and bounds;
15. DINO slices: ``experiments/dino_nerf.yaml``, ``multiscale.yaml`` and
   ``lora.yaml`` read by the port's own YAML reader at full width (ViT-B/14
   12x768 extractor on the card, 8x256 trunk): feature maps (5, 9, 9, 64)
   or (5, 9, 9, 128); eval at init (kernel 2 with train view 0's features,
   one launch per chunk); epochs 0, 50, 100, 101 (``lora.yaml``: 0), every
   step launching kernel 1 once; epoch 0 against a ``backend: xla`` trainer
   (rel 1e-4); PSNR must rise; the trained views against the plain
   pipeline; both kernels against their plain versions at the trainer's
   shapes; the feature sampler's time; one ``dino_nerf`` phase-2 epoch
   traced;
16. evaluate dino_nerf.yaml, right after the ``dino_nerf.yaml`` slice: the
   same for its trained trainer (features from the extractor on the card,
   1024-ray chunks: 304 launches; the 5x5 feature-consistency matrix);
17. LoRA trunk kernel width: kernel 1 at 512x64 and 1024x64 and kernel 2
   at a 1024x64 eval chunk at the trunk-LoRA config's input (pos_freq 10,
   view directions, 64 features: D 160), against their plain versions;
   times and bounds;
18. LoRA trunk slice: ``experiments/lora_nerf_trunk.yaml`` read by the
   port's reader (8x256 trunk, rank-4 LoRA on every layer, the ViT-B/14
   extractor on the card), trained with ``sigma_bias: 0.1`` (the file as it
   stands starts dead at seed 0, which is reported): epochs 0, 50, 51, 52,
   100 through kernel 1 with the merged weights, the freeze at 51 (base and
   heads bit-equal after it, every ``lora_b`` moved), epoch 0 against a
   ``backend: xla`` twin and the freeze as the first call of a kernel and an
   ``xla`` trainer (rel 1e-4), eval through kernel 2 (PSNR must rise), the
   views against the plain pipeline, both kernels at the trainer's shapes,
   one phase-2 epoch traced;
19. reference checkpoint: the trained LoRA weights written in the
   reference's PyTorch layout (``.pth``) and loaded into a fresh trainer,
   whose views through kernel 2 must equal the first trainer's;
20. module and skip slice: ``multiscale.yaml`` with ``arch: module``
   (``NeRFWithDINO``) and ``baseline.yaml`` with ``skip_layers: [4]`` take
   the plain path with the JAX trainer's reason and launch no kernel, raise
   under ``backend: fused``; the module config trains two epochs and its
   PSNR must rise;
21. script kernel widths: the five kernels at the script recipes' input
   (pos_freq 10 and the 768 channels of the ViT-B/16 patch embedding, random
   inputs): kernel 1 at D 832 (no view directions) and 864 at 1024x32 and
   4096x64 (and a white, masked, reg and depth case), kernel 2 at D 832
   and 864 on a 2048x64 chunk, kernels 4, 3 and 5 from a 896-wide x at
   512x64; every second call bit for bit, the pad rows' gradients zero,
   the existing gates; times, bounds on the live columns (831 / 858),
   shares;
22. script slice: ``script_baseline_live.yaml``, ``script_projection.yaml``
   and ``script_lora.yaml`` read by the port's reader, on the patch-embed
   extractor's (5, 14, 14, 768) maps computed on the card: a file whose
   seed-0 init is dead as it stands trains with ``sigma_bias: 0.1``, which
   is printed; one epoch of each phase (``script_lora`` 0, 50, 51, 52
   across its freeze, base and heads bit-equal after it), 5 full-image
   steps each through kernel 1 (launches = steps), epoch 0 against a
   ``backend: xla`` twin (rel 1e-4), eval through kernel 2 (one launch per
   chunk), PSNR rising, the trained views against the plain pipeline, both
   kernels and the 768-channel feature sampler at the trainer's shapes;
   one 64x64 epoch of ``script_projection`` traced, then a differentiable
   render step (kernels 4 and 3) and an ``inline_pe=False`` step (kernel
   5) on its 896-wide x; ``script_baseline.yaml`` (no sigma bias) through
   ``fit`` for 6 epochs, its ``dead_sigma_epochs`` reported, not gated;
23. CLI: ``python -m nerf_fewshot_tpu_torch.cli train --config
   experiments/dino_nerf.yaml --synthetic --epochs 2`` as a subprocess
   must exit 0, write ``final.ckpt`` and print the summary JSON with the
   kernel path.

Any failure raises and exits non-zero. On success the last three lines are
the ``nvidia-smi`` name/power-limit line, a JSON line with the kernels'
numbers (the five kernels, kernels 1 and 2 at the DINO widths, then at the
trunk-LoRA width, then the five at the script recipes' widths), and
``{"ok": true, "device": {...}}``.
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

# experiments/hierarchical.yaml, parsed (a CPU test holds the two equal).
HIERARCHICAL_CONFIG = {
    "experiment": {"name": "NeRF-Hierarchical-Lego"},
    "data": {"dataset": "nerf_synthetic", "scene": "lego", "num_views": 5,
             "resolution": 128, "near": 2.0, "far": 6.0},
    "model": {"use_dino": False},
    "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 256, "num_layers": 8,
                   "sigma_bias": 0.1},
    "training": {"epochs": 200, "batch_size": 1024,
                 "progressive_schedule": {"epochs_0_50": [32, 32, 32],
                                          "epochs_50_100": [64, 64, 48],
                                          "epochs_100_plus": [128, 128, 64]}},
    "optimizer": {"lr": 0.0005, "weight_decay": 1e-06, "lr_milestones": [100, 150],
                  "lr_gamma": 0.5},
    "loss": {"rgb_weight": 1.0, "depth_weight": 0.0, "reg_weight": 0.0},
    "rendering": {"near": 2.0, "far": 6.0, "chunk_size": 2048, "noise_std": 0.0,
                  "white_bkgd": False, "n_importance": 64, "backend": "auto"},
    "output": {"save_dir": "results/hierarchical_lego", "val_freq": 10, "save_freq": 100},
}

# experiments/smoke.yaml, parsed (a CPU test holds the two equal): width 64,
# which the kernels do not take.
SMOKE_CONFIG = {
    "experiment": {"name": "smoke"},
    "data": {"dataset": "nerf_synthetic", "scene": "synthetic", "num_views": 4,
             "resolution": 32, "near": 2.0, "far": 6.0, "source": "synthetic"},
    "model": {"use_dino": False},
    "nerf_model": {"pos_freq": 8, "dir_freq": 2, "hidden_dim": 64, "num_layers": 4,
                   "sigma_bias": 0.1},
    "training": {"epochs": 10, "batch_size": 512,
                 "progressive_schedule": {"epochs_0_50": [32, 32, 32],
                                          "epochs_50_100": [32, 32, 32],
                                          "epochs_100_plus": [32, 32, 32]}},
    "optimizer": {"lr": 0.005, "weight_decay": 1e-06, "lr_milestones": [1000],
                  "lr_gamma": 0.5},
    "loss": {"rgb_weight": 1.0, "depth_weight": 0.0, "reg_weight": 0.0},
    "rendering": {"near": 2.0, "far": 6.0, "chunk_size": 1024, "noise_std": 0.0,
                  "white_bkgd": True},
    "output": {"save_dir": "results/smoke", "val_freq": 5, "save_freq": 10},
}

# H100 SXM published peaks (dense): FP32 on the CUDA cores, TF32 on the
# tensor cores, HBM3 bandwidth. All five kernels run their trunk products as
# 3xTF32 (three TF32 products each), so their bound is 3 * FLOPs at the TF32
# rate; the bound at the fp32 CUDA-core rate is printed beside it.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain: the kernel's 3xTF32 trunk products (~2^-22 off each) and
# fp32 sums in another order than cuBLAS's; depth sums w*z with z up to 6.
TOL = {"rgb": 1e-4, "depth": 1e-3, "acc": 1e-4, "weights": 1e-4}
# Train kernel vs plain: loss rel 1e-5; the six packed gradients as one
# vector rel 1e-4, and 2e-2 at sigma_bias 5.0, where the backward divides by
# transmittances at the 1e-10 floor (the JAX gate, render/verify.py).
TRAIN_GRAD_TOL, TRAIN_GRAD_TOL_SATURATED = 1e-4, 2e-2
# Kernel trainer vs plain trainer, per-step losses of epoch 0; the
# differentiable render steps vs plain autograd, per-step losses of the
# first RENDER_STEPS_GATED steps.
TRAIN_LOSS_RTOL = 1e-4
RENDER_STEPS, RENDER_STEPS_HIER, RENDER_STEPS_GATED = 30, 15, 5
RENDER_STEPS_TRACED = 10  # fused steps per profiled window
# fused_train_loss_grad(inline_pe=False) vs inline_pe=True, hierarchical:
# kernel 2's sin(x + pi/2) and the encoded x's cos shift the importance
# samples by ~1e-6, so the two losses differ by up to about 1e-4 rel.
INLINE_PE_LOSS_RTOL = 1e-3
N_TEST_VIEWS, N_TRAIN_VIEWS = 8, 5
# cli evaluate: the orbit and the depth views it renders beside the test views
N_ORBIT, N_DEPTH_VIEWS = 8, 3
# LPIPS on the card (cuDNN convs, TF32 cleared) vs the CPU: fp32 sums in other
# orders, within 1.6e-7 rel on an NVIDIA H100 80GB HBM3 (700 W); with cuDNN's
# TF32 on the same pairs read 4.4-4.8e-5 off, inside 1e-4, so the gate sits at
# 1e-5 to see that trap.
LPIPS_RTOL = 1e-5
KERNELS = ("fwd_pe", "train_pe")  # the sources, one nvcc each
# one epoch of each phase and one more at 32x32 and at 128x128: the first
# epoch's steps include the first use (module loading) of every CUDA kernel
TRAIN_EPOCHS = (0, 1, 50, 100, 101)
ROOT = os.path.dirname(os.path.abspath(__file__))
# The DINO experiment files, read by the port's own YAML reader; the
# single- and multi-scale ones train at DINO_EPOCHS (one epoch of each phase
# and one more at 128x128), lora.yaml one epoch. Per extractor: the feature
# width Fd and the kernels' padded input width D at pos_freq 12
# (6 + 96 + Fd columns, to a multiple of 16).
DINO_CONFIGS = ("dino_nerf.yaml", "multiscale.yaml", "lora.yaml")
DINO_EPOCHS = (0, 50, 100, 101)
DINO_WIDTHS = {"single_scale": (64, 176), "multi_scale": (128, 240)}
# The trunk-LoRA slice: experiments/lora_nerf_trunk.yaml at the epochs of the
# full model (0, 50), the freeze (51: a fresh optimizer over the LoRA pairs),
# one more (52) and phase 2 (100); its feature width and the kernels' padded
# input width (6 + 84 + 64 live columns at pos_freq 10, to a multiple of 16).
LORA_TRUNK_CONFIG = "lora_nerf_trunk.yaml"
LORA_EPOCHS = (0, 50, 51, 52, 100)
LORA_WIDTH = (64, 160)
# arch: module (multiscale.yaml) trains one epoch of each of its first two phases
MODULE_EPOCHS = (0, 50)
# The script recipes (experiments/script_*.yaml): the 768 channels of the
# ViT-B/16 patch embedding at pos_freq 10; per view-direction flag the live
# input columns and the kernels' padded input width (63 or 90 PE columns + 768,
# to a multiple of 16); kernels 3, 4 and 5 take the encoded x, 896 wide. The
# slice trains one epoch of each phase (script_lora: across its freeze at 51),
# 5 full-image steps each, and script_baseline.yaml (no sigma bias) for
# SCRIPT_DEAD_EPOCHS epochs, reporting its dead-sigma count.
SCRIPT_FD = 768
SCRIPT_WIDTHS = {False: (831, 832), True: (858, 864)}
SCRIPT_X = 896
SCRIPT_EPOCHS = {"script_baseline_live.yaml": (0, 50, 100),
                 "script_projection.yaml": (0, 50, 100),
                 "script_lora.yaml": (0, 50, 51, 52)}
SCRIPT_TRACED = "script_projection.yaml"  # its 64x64 x 64-sample epoch is traced
SCRIPT_DEAD_CONFIG, SCRIPT_DEAD_EPOCHS = "script_baseline.yaml", 6


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


def bounds(flops, nbytes, tensor_cores):
    """``(bound_ms, bound_by, rate)``: the larger of the operations at the
    peak of the units that run them (3xTF32 on the tensor cores, or fp32 on
    the CUDA cores) and the bytes at the HBM rate."""
    ops_s = 3.0 * flops / TF32_FLOPS if tensor_cores else flops / FP32_FLOPS
    bytes_s = nbytes / HBM_BYTES_PER_S
    rate = "3xTF32 at 495 TFLOP/s" if tensor_cores else "fp32 at 67 TFLOP/s"
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes", rate


def f64_report(name, got, plain, exact):
    """Rel error of the kernel's and of the fp32 plain version's flat result
    (loss and gradients, or dx and gradients) against the float64 run (for
    the objective, ``tools/f64_cases.py:objective_f64``: from the fp32
    encoded input, since at pos_freq 10 the PE phases reach ~2^9 rad, where
    a float64 PE would move x by more than the trunk's rounding does)."""
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts if t is not None])
    e = flat(exact)
    rel = lambda r: ((flat(r) - e).norm() / e.norm()).item()
    print(f"  {name} vs a float64 run of the plain version: kernel rel {rel(got):.2e}, fp32 plain "
          f"version rel {rel(plain):.2e}", flush=True)


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


def random_fwd_pe_args(rng, R, S, H, L, feat_dim, device, pos_freq=10, d_pad=None,
                       use_viewdirs=True):
    """Random inputs of the given shape: torch-default-bounded weights,
    points in the scene box, depths in [2, 6]; the input padded to ``d_pad``
    (default: a multiple of 128)."""
    from nerf_fewshot_tpu_torch.render import kernels as tk

    perm, e2, c, x_dim = tk.pe_layout(pos_freq, 4, use_viewdirs, feat_dim)

    def u(fan_in, *shape):
        return torch.tensor((rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32))

    state = {"trunk.0.weight": u(x_dim, H, x_dim), "trunk.0.bias": u(x_dim, H)}
    for i in range(1, L):
        state[f"trunk.{i}.weight"] = u(H, H, H)
        state[f"trunk.{i}.bias"] = u(H, H)
    state.update({"rgb_head.weight": u(H, 3, H), "rgb_head.bias": u(H, 3),
                  "sigma_head.weight": u(H, 1, H), "sigma_head.bias": torch.full((1,), 0.1)})
    packed = tk.pack_params(state, L, H, d_pad=d_pad or -(-x_dim // 128) * 128, row_perm=perm)
    pts = torch.tensor(rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32))
    rd = torch.tensor(rng.standard_normal((R, 3)).astype(np.float32))
    z = torch.tensor(np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32))
    feats = (torch.tensor(rng.standard_normal((R * S, feat_dim)).astype(np.float32))
             if feat_dim else None)
    on = lambda t: None if t is None else t.to(device)
    return (on(tk._raw_block(pts, rd, use_viewdirs)), on(feats), on(z),
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
                      inline_pe=True, pos_freq=10, use_viewdirs=True):
    """Random inputs of the train kernel as ``fused_train_loss_grad`` builds
    them: random weights (``random_state``), rays from (0, 0, 4) into the
    scene volume, jittered samples in [2, 6], uniform rgb targets, the last
    ``ragged`` rays masked out, depth targets in [2.5, 5.5] when
    ``depth_weight``, features ``tanh(pts @ W)`` when ``feat_dim``, PE at
    ``pos_freq`` (with view directions at dir_freq 4 unless not
    ``use_viewdirs``). Returns ``(args, opts)`` for
    ``fused_train_objective(*args, **opts)``."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

    x_dim = 6 * pos_freq + (30 if use_viewdirs else 3) + feat_dim
    state = {k: v.to(device) for k, v in random_state(rng, x_dim, H, L, sigma_bias).items()}
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
        on(mask), settings, pos_freq, 4, L, H, use_viewdirs=use_viewdirs,
        uniforms=on(rng.uniform(0, 1, (R, S))), inline_pe=inline_pe, reg_weight=reg_weight,
        depth_weight=depth_weight,
        target_depth=on(rng.uniform(2.5, 5.5, R)) if depth_weight else None, point_features_fn=pf)


def random_render_args(rng, R, S, H, L, device, *, feat_dim=0, sigma_bias=0.1, pos_freq=10):
    """Random inputs of kernels 4 and 3 as ``fused_render_rays`` builds them:
    random weights (``random_state``), rays from (0, 0, 4) into the scene
    volume, jittered samples in [2, 6], ``x = encode_points(...)`` at
    ``pos_freq`` (128 wide at 10, 256 with 64-wide features ``tanh(pts @
    W)``). Returns ``(x, z, dnorm, packed)`` and the unpadded input width."""
    from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render.fused import encode_points

    x_dim = 6 * pos_freq + 30 + feat_dim
    state = {k: v.to(device) for k, v in random_state(rng, x_dim, H, L, sigma_bias).items()}
    on = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    d = rng.standard_normal((R, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    rd = on(d)
    pts, z = sample_along_rays(on(np.broadcast_to([0.0, 0.0, 4.0], (R, 3))), rd, 2.0, 6.0, S,
                               uniforms=on(rng.uniform(0, 1, (R, S))))
    feats = None
    if feat_dim:
        feats = torch.tanh(pts.reshape(-1, 3) @ on(rng.standard_normal((3, feat_dim))))
    x = encode_points(pts, rd, pos_freq, 4, True, feats).contiguous()
    packed = tk.pack_params(state, L, H, d_pad=x.shape[1])
    return (x, z.contiguous(), torch.linalg.norm(rd, dim=-1, keepdim=True), packed), x_dim


def random_cotangents(rng, R, S, device):
    """Standard-normal cotangents of the render's (rgb, depth, acc, weights)."""
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32), device=device)
                 for shape in ((R, 3), (R, 1), (R, 1), (R, S)))


def render_cost(args, x_dim, backward):
    """(FLOPs, bytes) of kernel 4 (``backward`` False) or kernel 3 on these
    inputs: the trunk and head over the ``x_dim`` real input columns (the
    padding is not counted); kernel 3 adds the backward chain, the dW
    products and dx; each input read once, each output written once."""
    x, z, dnorm, packed = args
    w0, b0, wh, bh, wout, bout = packed
    N, D = x.shape
    R, S = z.shape
    H, L1 = w0.shape[1], wh.shape[0]
    fwd = x_dim * H + L1 * H * H + H * 4
    if not backward:
        flops = 2.0 * N * fwd
        out_elems = R * 3 + R + R + R * S
        nbytes = 4.0 * (x.numel() + z.numel() + dnorm.numel()
                        + sum(p.numel() for p in packed) + out_elems)
        return flops, nbytes
    bwd = H * 4 + L1 * H * H
    flops = 2.0 * N * (2 * fwd + bwd + x_dim * H)
    cot_elems = R * 3 + R + R + R * S
    nbytes = 4.0 * (2 * x.numel() + z.numel() + dnorm.numel() + cot_elems
                    + 2 * sum(p.numel() for p in packed))
    return flops, nbytes


def compare_vjp(name, got, want, tol):
    """``dx`` and the six packed gradients as one vector: rel error <= tol,
    alive (norm > 1e-6), finite. Returns the max abs error."""
    flat = lambda dx, dp: torch.cat([t.reshape(-1).double() for t in (dx, *dp)])
    g, w = flat(*got), flat(*want)
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: kernel gradients are not finite")
    norm = w.norm().item()
    rel = (g - w).norm().item() / max(norm, 1e-30)
    max_err = (g - w).abs().max().item()
    print(f"  {name}: dx + packed grads rel err {rel:.2e} (tol {tol:.0e}), |g| {norm:.3e}, "
          f"max abs err {max_err:.2e}", flush=True)
    if not (norm > 1e-6 and rel <= tol):
        raise RuntimeError(f"{name}: kernel 3 disagrees with its plain version "
                           f"(rel {rel}, |g| {norm})")
    return max_err


def train_cost(args, opts, x_dim=None):
    """(FLOPs, bytes) the objective needs on these inputs: the forward trunk
    and head over the unpadded input width (inline PE; a pre-encoded x
    counts its whole width unless ``x_dim`` gives its live columns), the
    backward chain (head, then the hidden layers; no input gradient), the
    dW products; each input read once, each output written once."""
    inp, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed = args
    w0, b0, wh, bh, wout, bout = packed
    n_points = z.numel()
    H, L1 = w0.shape[1], wh.shape[0]
    if opts["inline_pe"]:
        x_dim = inp.shape[1] + e2.shape[1] + (0 if feats is None else feats.shape[1])
    elif x_dim is None:
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
    samples per ray with jitter uniforms, the trainer's weights and, with
    DINO conditioning, train view 0's feature sampler."""
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
        use_viewdirs=cfg.nerf.use_viewdirs,
        uniforms=torch.rand((B, p.n_samples), generator=g, device=device), inline_pe=inline_pe,
        point_features_fn=trainer.feature_sampler(0), lora_alpha=cfg.nerf.lora_alpha)


# Device-time groups of the profiled runs, by kernel name (first match).
KERNEL_GROUPS = ("train_fwd", "train_bwd", "train_dw", "train_composite", "render_composite",
                 "render_dx", "train_finalize", "loss_sum", "weight_split", "fwd_split",
                 "fwd_trunk", "fwd_composite")


def trace(run, with_cpu):
    """``run()`` (which returns its number of steps) under ``torch.profiler``.
    With the CUDA activity only (``with_cpu`` False) the host is slowed
    least: the device's busy time is the union of its kernel and copy
    intervals, set against the run's wall time, and the stream
    synchronizations the host made are counted. With the CPU activity too,
    Adam's device time is read from the optimizer's own
    ``Optimizer.step#...`` range. Device-side spans of annotated ranges are
    not kernels and are left out. Returns the wall ms, the busy ms, and per
    step: device ms by part (the CUDA kernels' launches by name, ``adam``
    with the CPU activity, ``other``: gather, sampling, encoding,
    ``pack_params`` and its backward, copies), device events and stream
    synchronizations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
        group = next((g for g in KERNEL_GROUPS if g in evt.name), "other")
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


def trace_epoch(trainer, epoch, with_cpu):
    """One ``train_epoch`` under ``trace``."""
    trainer.phase_data(trainer._phase_index(epoch))

    def run():
        trainer.train_epoch(epoch)
        return len(trainer.last_step_losses)

    return trace(run, with_cpu)


def print_launch_times(label, fn, calls=10):
    """Device ms per call of each grid launch that ``fn()`` makes (``trace``
    over ``calls`` calls, the CUDA activity only)."""
    fn()
    t = trace(lambda: len([fn() for _ in range(calls)]), with_cpu=False)
    print(f"  {label}, device ms per call by grid launch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(t["parts"].items(), key=lambda kv: -kv[1]))
        + f", sum {sum(t['parts'].values()):.3f}", flush=True)


def print_trace(label, t, untraced_ms):
    if not t["busy_ms"] > 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"  {label}: wall {t['wall_ms']:.1f} ms ({t['wall_ms'] / untraced_ms:.3f}x untraced), "
          f"device busy {t['busy_ms']:.1f} ms ({t['busy_ms'] / t['wall_ms']:.1%} of the traced "
          f"wall), per step: {t['events']:.1f} device events, {t['syncs']:.2f} stream "
          f"synchronizations, device ms " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(t["parts"].items(), key=lambda kv: -kv[1]))
          + f", sum {sum(t['parts'].values()):.3f}", flush=True)


def eval_chunk(trainer, pose, device):
    """The first eval chunk (``rendering.chunk_size`` rays) of a test view and its deterministic
    samples, as ``fused_render_rays`` makes them: ``(rd, pts, z)``."""
    from nerf_fewshot_tpu_torch.ops.rays import get_rays
    from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays

    cfg = trainer.cfg
    ro, rd = get_rays(trainer.H, trainer.W, trainer.focal,
                      torch.as_tensor(pose, dtype=torch.float32, device=device))
    chunk = cfg.rendering.chunk_size
    ro, rd = ro.reshape(-1, 3)[:chunk], rd.reshape(-1, 3)[:chunk]
    pts, z = sample_along_rays(ro, rd, cfg.rendering.near, cfg.rendering.far,
                               cfg.phases[-1].n_samples)
    return rd, pts, z.contiguous()


def main_path_fwd_pe_args(trainer, pose, device):
    """An eval chunk exactly as ``fused_render_rays(forward_only=True)``
    hands it to kernel 2, with the trainer's weights (and, with DINO
    conditioning, the features of train view 0's map at its points)."""
    from nerf_fewshot_tpu_torch.render import kernels as tk

    cfg = trainer.cfg
    rd, pts, z = eval_chunk(trainer, pose, device)
    pf = trainer.feature_sampler(0)
    feats = None if pf is None else pf(pts.reshape(-1, 3)).contiguous()
    viewdirs = cfg.nerf.use_viewdirs
    perm, e2, c, x_dim = tk.pe_layout(cfg.nerf.pos_freq, cfg.nerf.dir_freq, viewdirs,
                                      0 if feats is None else feats.shape[1])
    packed = tk.pack_params(trainer.model.state_dict(), cfg.nerf.num_layers,
                            cfg.nerf.hidden_dim, d_pad=tk.pe_width(x_dim), row_perm=perm,
                            lora_alpha=cfg.nerf.lora_alpha)
    return (tk._raw_block(pts, rd, viewdirs), feats, z,
            torch.linalg.norm(rd, dim=-1, keepdim=True),
            torch.as_tensor(e2, device=device), torch.as_tensor(c, device=device), packed)


def main_path_fwd_x_args(trainer, pose, device):
    """An eval chunk encoded as ``fused_render_rays(forward_only=False)``
    hands it to kernel 4, with the trainer's weights: ``(x, z, dnorm,
    packed)``."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render.fused import encode_points

    cfg = trainer.cfg
    rd, pts, z = eval_chunk(trainer, pose, device)
    x = encode_points(pts, rd, cfg.nerf.pos_freq, cfg.nerf.dir_freq, True).contiguous()
    packed = tk.pack_params(trainer.model.state_dict(), cfg.nerf.num_layers,
                            cfg.nerf.hidden_dim, d_pad=x.shape[1])
    return x, z, torch.linalg.norm(rd, dim=-1, keepdim=True), packed


def check_bit_equal(name, got, again):
    """Raises unless two calls on the same inputs gave the same bits."""
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise RuntimeError(f"{name}: two calls on the same inputs differ")
    print(f"  {name}: two calls agree bit for bit", flush=True)


def eval_ms(trainer):
    """The last ``evaluate()``'s render and LPIPS legs per view: the render
    rate stays a render number."""
    sec = trainer.eval_seconds
    return (f"render {sec['render'] / sec['views'] * 1e3:.2f} ms/view (LPIPS "
            f"{sec['lpips'] / sec['views'] * 1e3:.2f} ms/view apart)")


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
    the same seed, and return the launches of (train_pe, train_x) and the
    trained trainer."""
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
    return counts["train_pe"], counts["train_x"], ktr


def lpips_card_vs_cpu(label, pairs):
    """LPIPS of ``pairs`` ((H, W, 3) [0, 1] images) on the card, exact fp32
    (the metric clears cuDNN's TF32 for its convs), against the CPU: rel
    ``LPIPS_RTOL``. One more reading with cuDNN's TF32 left on, printed
    beside it and not gated."""
    from nerf_fewshot_tpu_torch.training.lpips import LPIPS, lpips_distance

    card, cpu = LPIPS(device="cuda"), LPIPS(device="cpu")
    got = np.array([card(p, t) for p, t in pairs])
    want = np.array([cpu(p, t) for p, t in pairs])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = np.array([float(lpips_distance(card.params, *(
            torch.as_tensor(x, device="cuda") * 2.0 - 1.0 for x in pair))) for pair in pairs])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    rel, rel_tf32 = (float(np.max(np.abs(v / want - 1.0))) for v in (got, tf32))
    print(f"  {label} LPIPS of {len(pairs)} pairs, card vs CPU: max rel {rel:.2e} (tol "
          f"{LPIPS_RTOL:.0e}); with cuDNN's TF32 left on: max rel {rel_tf32:.2e} (not gated); "
          f"card values {np.round(got, 6).tolist()}", flush=True)
    if not (np.isfinite(got).all() and rel <= LPIPS_RTOL):
        raise RuntimeError(f"{label}: LPIPS on the card differs from the CPU by rel {rel}")


def run_evaluate_phase(name, trainer, train, test, device, tk, smi, tmp):
    """``cli evaluate --config experiments/<name> --checkpoint <trainer's
    checkpoint> --synthetic`` in this process on the card (its default
    device): ``evaluation.json`` with the JAX harness's keys and its PNGs;
    kernel 2 launched once per chunk of each ``render_views`` call's
    stream (N_TEST_VIEWS test, N_ORBIT orbit and N_DEPTH_VIEWS depth
    views); the checkpoint through a ``backend: xla`` trainer's harness:
    the orbit and depth views within TOL, the depth means within 1e-3 and
    PSNR within 1e-3 dB; LPIPS on the card against the CPU; the ms per
    evaluated view (render and LPIPS apart), per orbit view and the wall
    time of the call. Returns kernel 2's launches in the call."""
    import contextlib
    import io

    from nerf_fewshot_tpu_torch import cli as tcli
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.evaluate import (comprehensive_evaluation,
                                                          generate_orbit_poses)
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = trainer.cfg
    ckpt, out_dir = os.path.join(tmp, "trained.ckpt"), os.path.join(tmp, "evaluation")
    trainer.save(ckpt)
    chunk, per = cfg.rendering.chunk_size, cfg.data.resolution ** 2
    want_launches = sum(-(-v * per // chunk) for v in (N_TEST_VIEWS, N_ORBIT, N_DEPTH_VIEWS))
    stdout = io.StringIO()
    tk.fused_render_fwd_pe.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        tcli.main(["evaluate", "--config", os.path.join(ROOT, "experiments", name),
                   "--checkpoint", ckpt, "--synthetic", "--output", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.fused_render_fwd_pe.launches
    lines = stdout.getvalue().splitlines()
    for line in lines[:-1]:
        print(f"  {line}", flush=True)
    with open(os.path.join(out_dir, "evaluation.json")) as f:
        res = json.load(f)
    if json.loads(lines[-1]) != res:
        raise RuntimeError(f"{name}: the printed results differ from evaluation.json")
    print(f"  cli evaluate {name}: {wall:.2f} s, kernel 2 {launches} launches for "
          f"{want_launches} chunks ({N_TEST_VIEWS} test, {N_ORBIT} orbit, {N_DEPTH_VIEWS} depth "
          f"views of {per} rays in {chunk}-ray chunks)", flush=True)
    if launches != want_launches:
        raise RuntimeError(f"{name}: evaluate launched kernel 2 {launches} times")

    m = res["metrics"]
    if (list(res) != ["metrics", "novel_views", "feature_3d_consistency", "depth", "smoothness",
                      "raw_feature_smoothness"]
            or list(m) != ["psnr", "ssim", "lpips", "lpips_pretrained", "lpips_backend"]
            or m["lpips_pretrained"] is not False or m["lpips_backend"] != "torch-random-vgg"
            or not all(np.isfinite(m[k]) for k in ("psnr", "ssim", "lpips"))
            or res["novel_views"] != N_ORBIT or len(res["depth"]["per_view"]) != N_DEPTH_VIEWS
            or set(res["smoothness"]) != {"sigma_smoothness", "rgb_smoothness"}
            or res["raw_feature_smoothness"].get("available") is not trainer.use_dino):
        raise RuntimeError(f"{name}: evaluation.json {json.dumps(res)[:2000]}")
    consistency = res["feature_3d_consistency"]
    if trainer.use_dino:
        sim = np.asarray(consistency["matrix"])
        if (sim.shape != (N_TRAIN_VIEWS, N_TRAIN_VIEWS) or not np.all(np.diag(sim) == 1.0)
                or not np.isfinite(sim).all()):
            raise RuntimeError(f"{name}: consistency matrix {sim}")
    elif consistency != {"available": False}:
        raise RuntimeError(f"{name}: feature_3d_consistency {consistency}")
    pngs = ([f"novel_{i:02d}.png" for i in range(N_ORBIT)]
            + [f"depth_{k}_{i}.png" for k in ("view", "hist_view") for i in range(N_DEPTH_VIEWS)]
            + [f"{k}_{i}.png" for k in ("render", "gt") for i in range(5)]
            + (["consistency_matrix.png"] if trainer.use_dino else []))
    if sorted(os.listdir(out_dir)) != sorted(pngs + ["evaluation.json"]) or not all(
            os.path.getsize(os.path.join(out_dir, p)) > 0 for p in pngs):
        raise RuntimeError(f"{name}: the PNGs written are {sorted(os.listdir(out_dir))}")
    print(f"  {name}: psnr {m['psnr']:.4f} dB, ssim {m['ssim']:.5f}, lpips {m['lpips']:.6f} "
          f"({m['lpips_backend']}); depth means " + ", ".join(
              f"{v['depth_mean']:.4f}" for v in res["depth"]["per_view"]) + "; smoothness "
          + json.dumps(res["smoothness"]) + "; raw feature smoothness "
          + json.dumps(res["raw_feature_smoothness"]) + f"; {len(pngs)} PNGs", flush=True)

    feats = None if trainer.dino_features is None else trainer.dino_features.cpu().numpy()
    plain = Trainer(config_from_dict({**cfg.raw, "rendering": {**cfg.raw["rendering"],
                                                               "backend": "xla"}}),
                    train, test, device=device, dino_features=feats)
    plain.load(ckpt)
    if plain._use_fused():
        raise RuntimeError("backend: xla still selects the kernel")
    tk.fused_render_fwd_pe.launches = 0
    pres = comprehensive_evaluation(plain, os.path.join(tmp, "plain"), n_orbit=N_ORBIT)
    if tk.fused_render_fwd_pe.launches:
        raise RuntimeError("the plain harness launched kernel 2")
    orbit = list(generate_orbit_poses(N_ORBIT))
    for label, poses in (("orbit", orbit), ("depth", test.poses[:N_DEPTH_VIEWS])):
        got, want = trainer.render_views(poses), plain.render_views(poses)
        errs = {k: float(np.abs(g - w).max()) for g, w, k in zip(got, want, ("rgb", "depth", "acc"))}
        print(f"  {name} {label} views vs the plain pipeline: max abs err " + ", ".join(
            f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
        if not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items()):
            raise RuntimeError(f"{name}: {label} views disagree with the plain pipeline {errs}")
    dpsnr = abs(m["psnr"] - pres["metrics"]["psnr"])
    dmean = max(abs(a["depth_mean"] - b["depth_mean"])
                for a, b in zip(res["depth"]["per_view"], pres["depth"]["per_view"]))
    print(f"  {name} harness vs the plain pipeline's: psnr {dpsnr:.2e} dB apart (tol 1e-3), "
          f"depth means {dmean:.2e} apart (tol 1e-3), lpips {m['lpips']:.6f} vs "
          f"{pres['metrics']['lpips']:.6f}", flush=True)
    if not (dpsnr <= 1e-3 and dmean <= 1e-3):
        raise RuntimeError(f"{name}: the harness differs from the plain pipeline's")

    lpips_card_vs_cpu(name, list(zip(trainer.render_views(test.poses)[0],
                                     test.white_composited())))
    trainer.evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.render_views(orbit)
    orbit_ms = (time.perf_counter() - t0) / N_ORBIT * 1e3
    print(f"  {name} evaluate of {trainer.eval_seconds['views']} views: {eval_ms(trainer)}; "
          f"orbit {orbit_ms:.2f} ms/view; the whole cli evaluate call {wall:.2f} s; {smi}",
          flush=True)
    return launches


def main_path_render_bwd_args(trainer, device, seed=0):
    """One differentiable-render step's input to kernel 3 at the baseline's
    phase-2 batch: 512 train-view-0 rays x 64 jittered samples, encoded,
    the trainer's weights, standard-normal cotangents."""
    from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render.fused import encode_points

    cfg = trainer.cfg
    last = len(cfg.phases) - 1
    p = cfg.phases[last]
    pd = trainer.phase_data(last)
    g = torch.Generator(device).manual_seed(seed)
    idx = torch.randperm(pd.rays_o.shape[1], generator=g, device=device)[:p.batch_size]
    ro, rd = pd.rays_o[0][idx], pd.rays_d[0][idx]
    pts, z = sample_along_rays(ro, rd, cfg.rendering.near, cfg.rendering.far, p.n_samples,
                               uniforms=torch.rand((len(idx), p.n_samples), generator=g,
                                                   device=device))
    x = encode_points(pts, rd, cfg.nerf.pos_freq, cfg.nerf.dir_freq, True).contiguous()
    packed = tk.pack_params(trainer.model.state_dict(), cfg.nerf.num_layers,
                            cfg.nerf.hidden_dim, d_pad=x.shape[1])
    args = (x, z.contiguous(), torch.linalg.norm(rd, dim=-1, keepdim=True), packed)
    return args, random_cotangents(np.random.default_rng(seed), len(idx), p.n_samples, device)


def render_stepper(cfg, pd, device, n_importance, fused):
    """A function that takes one Adam step of the baseline ``NeRFMLP`` (its
    init from ``cfg.seed``) on a batch of the last phase's shape (512 rays x
    64 jittered samples of the 128x128 views) and returns its loss, a loss
    on every output of the render:
    rgb MSE + 0.01 mean(w^2) + 1e-3 mean(|depth - 4|) + 1e-3 mean(acc),
    through ``fused_render_rays(forward_only=False)`` (``fused``) or the
    plain ``render_rays`` and autograd. Batches and uniforms come from a
    generator seeded with ``cfg.seed``, so both routes see the same ones."""
    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
    from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
    from nerf_fewshot_tpu_torch.training.optim import make_optimizer

    n = cfg.nerf
    model = NeRFMLP(pos_freq=n.pos_freq, dir_freq=n.dir_freq, use_viewdirs=n.use_viewdirs,
                    hidden_dim=n.hidden_dim, num_layers=n.num_layers,
                    sigma_bias_init=n.sigma_bias,
                    generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    opt = make_optimizer(cfg.optimizer, model.parameters())
    r, p = cfg.rendering, cfg.phases[-1]
    S, n_rays = p.n_samples, pd.rays_o.shape[1]
    B = min(p.batch_size, n_rays)
    settings = RenderSettings(near=r.near, far=r.far, n_samples=S, n_importance=n_importance,
                              perturb=True, white_bkgd=r.white_bkgd)
    g = torch.Generator(device).manual_seed(cfg.seed)
    count = [0]

    def step():
        v = count[0] % pd.rays_o.shape[0]
        count[0] += 1
        idx = torch.randint(0, n_rays, (B,), generator=g, device=device)
        u = torch.rand((B, S), generator=g, device=device)
        ui = torch.rand((B, max(n_importance, 1)), generator=g, device=device)
        ro, rd, tgt = pd.rays_o[v][idx], pd.rays_d[v][idx], pd.targets[v][idx]
        if fused:
            out = fused_render_rays(dict(model.named_parameters()), ro, rd, settings,
                                    n.pos_freq, n.dir_freq, n.num_layers, n.hidden_dim,
                                    n.use_viewdirs, device=device, uniforms=u,
                                    importance_uniforms=ui)
        else:
            out = render_rays(model, ro, rd, settings, u, ui)
        loss = (torch.mean((out.rgb - tgt) ** 2) + 0.01 * torch.mean(out.weights ** 2)
                + 1e-3 * torch.mean(torch.abs(out.depth - 4.0)) + 1e-3 * torch.mean(out.acc))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def render_steps(cfg, pd, device, n_importance, steps, fused):
    """``steps`` steps of ``render_stepper``: the per-step losses and the ms
    per step after the first (host clock, ended by a synchronization; the
    first step includes one-time set-up)."""
    step = render_stepper(cfg, pd, device, n_importance, fused)
    losses = [step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps - 1)]
    losses = torch.stack(losses).cpu().numpy()
    return losses, (time.perf_counter() - t0) / (steps - 1) * 1e3


def run_render_steps(cfg, trainer, device, tk):
    """The differentiable render path: RENDER_STEPS steps (and
    RENDER_STEPS_HIER hierarchical ones, n_importance 64) through the fused
    render against the same steps through the plain pipeline; returns the
    launches of kernels 4 and 3 over the fused runs."""
    pd = trainer.phase_data(len(cfg.phases) - 1)
    tk.fused_render_fwd.launches = 0
    tk.fused_render_bwd.launches = 0
    want_fwd = want_bwd = 0
    for n_imp, steps in ((0, RENDER_STEPS), (64, RENDER_STEPS_HIER)):
        got, k_ms = render_steps(cfg, pd, device, n_imp, steps, fused=True)
        want, p_ms = render_steps(cfg, pd, device, n_imp, steps, fused=False)
        want_fwd += steps * (2 if n_imp else 1)
        want_bwd += steps
        if not np.isfinite(got).all():
            raise RuntimeError(f"n_importance {n_imp}: non-finite losses {got}")
        rel = np.abs(got / want - 1.0)
        gated = rel[:RENDER_STEPS_GATED].max()
        p = cfg.phases[-1]
        print(f"  n_importance {n_imp}, {p.batch_size} x {p.n_samples} + {n_imp} samples: "
              f"{steps} steps, after the first: fused "
              f"{k_ms:.3f} ms/step, plain {p_ms:.3f} ms/step; loss {got[0]:.6f} -> {got[-1]:.6f}; "
              f"per-step rel gap to the plain route: first {RENDER_STEPS_GATED} steps max "
              f"{gated:.2e} (tol {TRAIN_LOSS_RTOL:.0e}), all steps max {rel.max():.2e}",
              flush=True)
        if not gated <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"n_importance {n_imp}: fused and plain render steps differ by "
                               f"rel {gated} (tol {TRAIN_LOSS_RTOL})")
    counts = (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches)
    print(f"  launches: kernel 4 {counts[0]}, kernel 3 {counts[1]} for "
          f"{RENDER_STEPS + RENDER_STEPS_HIER} steps", flush=True)
    if counts != (want_fwd, want_bwd):
        raise RuntimeError(f"launches {counts}, expected {(want_fwd, want_bwd)}")
    # where a fused step's time goes (these launches are not the path's count)
    for n_imp in (0, 64):
        step = render_stepper(cfg, pd, device, n_imp, fused=True)
        run = lambda: len([step() for _ in range(RENDER_STEPS_TRACED)])
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        print(f"  fused step, n_importance {n_imp}, untraced: "
              f"{untraced_ms / RENDER_STEPS_TRACED:.3f} ms/step", flush=True)
        for with_cpu in (False, True):
            print_trace(f"n_importance {n_imp} traced ({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                        trace(run, with_cpu), untraced_ms)
    return counts


def run_hierarchical_slice(train, test, device, tk, tt):
    """``experiments/hierarchical.yaml`` through ``Trainer(device="cuda")``:
    eval at init, ``train_epoch`` at TRAIN_EPOCHS (every step: kernel 2 for
    the coarse pass, kernel 1 over the merged samples), eval again (kernel 2
    for both passes of every chunk), CUDA-event times of kernel 1 at the
    merged 512 x 128 and of kernel 2 as the coarse pass, and one
    ``fused_train_loss_grad(inline_pe=False)`` step (kernel 4 as the coarse
    pass, kernel 5 as the objective) against the inline-PE step. Returns the
    launches of kernel 5 in this run."""
    from nerf_fewshot_tpu_torch.render.kernels import _raw_block, pack_params, pe_layout, pe_width
    from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict(HIERARCHICAL_CONFIG)
    tr = Trainer(cfg, train, test, device=device)
    if not tr._use_fused() or tr.kernel_path != "kernel":
        raise RuntimeError(f"hierarchical.yaml takes the {tr.kernel_path} path")
    n_chunks = -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    tk.fused_render_fwd_pe.launches = 0
    psnr0 = tr.evaluate()["psnr"]
    if tk.fused_render_fwd_pe.launches != 2 * n_chunks:
        raise RuntimeError(f"eval: {tk.fused_render_fwd_pe.launches} launches for {n_chunks} "
                           f"chunks of two passes")
    for i in range(len(cfg.phases)):
        tr.phase_data(i)
    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    tk.fused_render_fwd_pe.launches = 0
    tk.fused_render_fwd.launches = 0
    steps = 0
    for e in TRAIN_EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = len(tr.last_step_losses)
        steps += n
        p = cfg.phase_for_epoch(e)
        pd = tr.phase_data(tr._phase_index(e))
        rays = tr.n_views * pd.rays_o.shape[1]
        print(f"  hierarchical epoch {e} ({pd.H}x{pd.W}, {p.n_samples} + "
              f"{cfg.rendering.n_importance} samples, {min(p.batch_size, pd.rays_o.shape[1])} rays "
              f"per step): loss {loss:.6f}, {n} steps, {sec:.3f} s, {sec / n * 1e3:.3f} ms/step, "
              f"{rays / sec:.0f} rays/s", flush=True)
        if not np.isfinite(tr.last_step_losses).all():
            raise RuntimeError(f"epoch {e}: non-finite losses {tr.last_step_losses}")
    counts = (tt.fused_train_objective.launches["train_pe"], tk.fused_render_fwd_pe.launches)
    print(f"  launches: kernel 1 {counts[0]}, kernel 2 (coarse) {counts[1]} for {steps} steps",
          flush=True)
    if counts != (steps, steps):
        raise RuntimeError(f"launches {counts} for {steps} steps")
    tk.fused_render_fwd_pe.launches = 0
    after = tr.evaluate()
    print(f"  evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after {steps} steps, "
          f"ssim {after['ssim']:.5f}, {eval_ms(tr)}, "
          f"{tk.fused_render_fwd_pe.launches} launches for {n_chunks} chunks", flush=True)
    if tk.fused_render_fwd_pe.launches != 2 * n_chunks:
        raise RuntimeError("eval: not two kernel-2 launches per chunk")
    if not after["psnr"] > psnr0:
        raise RuntimeError(f"psnr after training {after['psnr']} <= at init {psnr0}")

    # kernel times at the step's shapes (phase 2: 512 rays, 64 + 64 samples)
    last = len(cfg.phases) - 1
    p = cfg.phases[last]
    g = torch.Generator(device).manual_seed(cfg.seed)
    pd = tr.phase_data(last)
    idx = torch.randperm(pd.rays_o.shape[1], generator=g, device=device)[:p.batch_size]
    B = len(idx)
    ro, rd, tgt = pd.rays_o[0][idx], pd.rays_d[0][idx], pd.targets[0][idx]
    u = torch.rand((B, p.n_samples), generator=g, device=device)
    ui = torch.rand((B, cfg.rendering.n_importance), generator=g, device=device)
    settings = tr._render_settings(p.n_samples, training=True)
    state = {k: v.detach() for k, v in tr.model.named_parameters()}
    n = cfg.nerf
    a, o = tt.train_objective_inputs(state, ro, rd, tgt, torch.ones(B, device=device), settings,
                                     n.pos_freq, n.dir_freq, n.num_layers, n.hidden_dim,
                                     uniforms=u, importance_uniforms=ui)
    k1_ms = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=10)
    pts, z = sample_along_rays(ro, rd, settings.near, settings.far, p.n_samples, uniforms=u)
    perm, e2, c, x_dim = pe_layout(n.pos_freq, n.dir_freq, True, 0)
    coarse = (_raw_block(pts, rd, True), None, z.contiguous(),
              torch.linalg.norm(rd, dim=-1, keepdim=True), torch.as_tensor(e2, device=device),
              torch.as_tensor(c, device=device),
              pack_params(state, n.num_layers, n.hidden_dim, d_pad=pe_width(x_dim), row_perm=perm))
    k2_ms = cuda_ms(lambda: tk.fused_render_fwd_pe(*coarse), iters=20)
    print(f"  kernel ms at the step's shapes: kernel 1 over {B} x {a[2].shape[1]} merged samples "
          f"{k1_ms:.3f}, kernel 2 as the coarse pass over {B} x {p.n_samples} {k2_ms:.3f}",
          flush=True)

    # the pre-encoded-x route: kernel 4 as the coarse pass, kernel 5 as the objective
    kw = dict(uniforms=u, importance_uniforms=ui)
    args = (state, ro, rd, tgt, torch.ones(B, device=device), settings, n.pos_freq, n.dir_freq,
            n.num_layers, n.hidden_dim)
    before = (tk.fused_render_fwd.launches, tt.fused_train_objective.launches["train_x"])
    lx, gx = tt.fused_train_loss_grad(*args, inline_pe=False, **kw)
    lp, gp = tt.fused_train_loss_grad(*args, inline_pe=True, **kw)
    after_x = (tk.fused_render_fwd.launches, tt.fused_train_objective.launches["train_x"])
    flat = lambda gr: torch.cat([gr[k].reshape(-1).double() for k in sorted(gr)])
    loss_rel = abs(lx.item() / lp.item() - 1.0)
    grad_rel = ((flat(gx) - flat(gp)).norm() / flat(gp).norm()).item()
    print(f"  inline_pe=False vs True, {B} x {p.n_samples} + {cfg.rendering.n_importance}: "
          f"loss {lx.item():.6e} vs {lp.item():.6e}, rel {loss_rel:.2e} (tol "
          f"{INLINE_PE_LOSS_RTOL:.0e}), grad rel {grad_rel:.2e}; launches kernel 4 "
          f"+{after_x[0] - before[0]}, kernel 5 +{after_x[1] - before[1]}", flush=True)
    if after_x != (before[0] + 1, before[1] + 1):
        raise RuntimeError("the inline_pe=False step did not launch kernels 4 and 5 once each")
    if not loss_rel <= INLINE_PE_LOSS_RTOL:
        raise RuntimeError(f"inline_pe=False and True losses differ by rel {loss_rel}")
    return tt.fused_train_objective.launches["train_x"]


def run_repair_check(train, device, tk, tt):
    """``smoke.yaml`` (width 64, ``backend: auto``) trains a phase-0 epoch on
    the card on the plain path, as the JAX trainer does, and records why in
    ``kernel_path``; under ``backend: fused`` it raises, and so does width 384
    (the JAX kernels take it; the port has no build for it) under ``auto``."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    before = (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches)
    tr = Trainer(config_from_dict(SMOKE_CONFIG), train, device=device)
    loss = tr.train_epoch(0)
    print(f"  smoke.yaml (hidden_dim 64, backend auto): {len(tr.last_step_losses)} steps, loss "
          f"{loss:.6f}, kernel_path: {tr.kernel_path} ({tr.kernel_path_reason})", flush=True)
    if not np.isfinite(loss) or tr.kernel_path != "plain":
        raise RuntimeError(f"smoke.yaml: loss {loss}, path {tr.kernel_path}")
    if (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches) != before:
        raise RuntimeError("the plain path launched a kernel")
    for label, over in (("width 64, backend fused", {"rendering": {
            **SMOKE_CONFIG["rendering"], "backend": "fused"}}),
            ("width 384, backend auto", {"nerf_model": {
                **SMOKE_CONFIG["nerf_model"], "hidden_dim": 384}})):
        try:
            Trainer(config_from_dict({**SMOKE_CONFIG, **over}), train, device=device).train_epoch(0)
        except ValueError as err:
            print(f"  {label}: raises ({err})", flush=True)
        else:
            raise RuntimeError(f"{label} trained on the card")


def run_dino_kernel_widths(device, tk, tt):
    """Kernel 1 at 512x64 and kernel 2 at a 1024x64 eval chunk, pos_freq 12,
    with 64 and 128 features (D 176 and 240), random inputs, against their
    plain versions at the existing gates; CUDA-event times and bounds.
    Returns ``{(kernel, D): (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    bound32_ms)}``."""
    rng = np.random.default_rng(12)
    rows = {}
    for fd, d in DINO_WIDTHS.values():
        cases = ((f"512x64 white, 9 masked, reg, depth, Fd {fd}",
                  dict(white_bkgd=True, ragged=9, reg_weight=0.01, depth_weight=0.1)),
                 (f"512x64 Fd {fd}", {}))
        err = 0.0
        for label, kw in cases:
            a, o = random_train_args(rng, 512, 64, 256, 8, device, feat_dim=fd, pos_freq=12, **kw)
            if a[-1][0].shape[0] != d:
                raise RuntimeError(f"Fd {fd}: the train kernel's input is {a[-1][0].shape[0]} wide")
            err = max(err, compare_train(
                f"kernel 1 pos_freq 12, D {d}, {label}", tt.fused_train_objective(*a, **o),
                tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL))
        k_ms = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=20)
        p_ms = cuda_ms(lambda: tt.fused_train_objective_reference(*a, **o), iters=5)
        flops, nbytes = train_cost(a, o)
        b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
        b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
        rows[("train_pe", d)] = (err, k_ms, p_ms, b_ms, b_by, b32_ms)
        print(f"  kernel 1 512x64 D {d}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by} as 3xTF32 (share {b_ms / k_ms:.1%}; {b32_ms:.3f} ms fp32; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)

        args = random_fwd_pe_args(rng, 1024, 64, 256, 8, fd, device, pos_freq=12,
                                  d_pad=tk.pe_width(6 + 96 + fd))
        if args[-1][0].shape[0] != d:
            raise RuntimeError(f"Fd {fd}: kernel 2's input is {args[-1][0].shape[0]} wide")
        err = 0.0
        for white in (False, True):
            kw = dict(white_bkgd=white, use_feats=True)
            err = max(err, compare(f"kernel 2 pos_freq 12, D {d}, 1024x64 white_bkgd={white}",
                                   tk.fused_render_fwd_pe(*args, **kw),
                                   tk.fused_render_fwd_pe_reference(*args, **kw)))
        k_ms = cuda_ms(lambda: tk.fused_render_fwd_pe(*args, use_feats=True), iters=20)
        p_ms = cuda_ms(lambda: tk.fused_render_fwd_pe_reference(*args, use_feats=True), iters=10)
        flops, nbytes = fwd_pe_cost(args, use_feats=True)
        b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
        b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
        rows[("fwd_pe", d)] = (err, k_ms, p_ms, b_ms, b_by, b32_ms)
        print(f"  kernel 2 1024x64 D {d}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by} as 3xTF32 (share {b_ms / k_ms:.1%}; {b32_ms:.3f} ms fp32; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    return rows


def run_dino_slice(name, train, test, device, tk, tt):
    """``experiments/<name>`` through the port's ``load_config`` at full
    width: the extractor (ViT-B/14, 12x768) on the card, one feature map per
    training view; ``evaluate`` at init (kernel 2 with train view 0's
    features, one launch per chunk); ``train_epoch`` at DINO_EPOCHS (one for
    lora.yaml), every step launching kernel 1 once with the view's
    features; epoch 0's per-step losses against a ``backend: xla`` trainer
    from the same seed, batches and features; PSNR after training above
    PSNR at init; the views against the plain pipeline with the trained
    weights; kernel 1 and kernel 2 against their plain versions at the
    trainer's own step and eval-chunk shapes. Returns a dict of the
    numbers."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = load_config(os.path.join(ROOT, "experiments", name))
    fd, d = DINO_WIDTHS[cfg.dino.model_type]
    widths = (cfg.nerf.hidden_dim, cfg.nerf.num_layers, cfg.nerf.pos_freq, cfg.dino.output_dim,
              cfg.data.resolution, cfg.data.num_views, cfg.rendering.chunk_size)
    if widths != (256, 8, 12, fd, 128, N_TRAIN_VIEWS, 1024):
        raise RuntimeError(f"{name}: widths {widths}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = _precompute_features(cfg, train, device)
    extract_s = time.perf_counter() - t0
    lora = cfg.dino.lora_rank if cfg.dino.use_lora else 0
    print(f"  {name}: {cfg.dino.model_type} extractor, ViT-B/14 12x768, LoRA rank {lora} -> "
          f"feature maps {tuple(feats.shape)} in {extract_s:.2f} s (build and {train.n_views} "
          f"views)", flush=True)
    if feats.shape != (N_TRAIN_VIEWS, 9, 9, fd) or not np.isfinite(feats).all():
        raise RuntimeError(f"{name}: feature maps {feats.shape}")

    ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
    pcfg = config_from_dict({**cfg.raw, "rendering": {**cfg.raw["rendering"], "backend": "xla"}})
    ptr = Trainer(pcfg, train, test, device=device, dino_features=feats)
    if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
        raise RuntimeError(f"{name}: paths {ktr.kernel_path}, {ptr.kernel_path}")
    n_chunks = -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    tk.fused_render_fwd_pe.launches = 0
    psnr0 = ktr.evaluate()["psnr"]
    if tk.fused_render_fwd_pe.launches != n_chunks:
        raise RuntimeError(f"{name}: eval {tk.fused_render_fwd_pe.launches} launches, "
                           f"{n_chunks} chunks")
    epochs = DINO_EPOCHS if name != "lora.yaml" else DINO_EPOCHS[:1]
    for e in epochs:
        ktr.phase_data(ktr._phase_index(e))

    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    steps, losses0, step_ms = 0, None, None
    for e in epochs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ktr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = len(ktr.last_step_losses)
        steps += n
        losses0 = ktr.last_step_losses.copy() if e == 0 else losses0
        p = cfg.phase_for_epoch(e)
        pd = ktr.phase_data(ktr._phase_index(e))
        step_ms = sec / n * 1e3
        print(f"  {name} epoch {e} ({pd.H}x{pd.W}, {min(p.batch_size, pd.rays_o.shape[1])} rays x "
              f"{p.n_samples} samples per step): loss {loss:.6f}, {n} steps, {sec:.3f} s, "
              f"{step_ms:.3f} ms/step, {ktr.n_views * pd.rays_o.shape[1] / sec:.0f} rays/s",
              flush=True)
        if not np.isfinite(ktr.last_step_losses).all():
            raise RuntimeError(f"{name} epoch {e}: non-finite losses")
    launches = tt.fused_train_objective.launches["train_pe"]
    print(f"  {name} launches: kernel 1 {launches} for {steps} steps", flush=True)
    if launches != steps:
        raise RuntimeError(f"{name}: {launches} kernel-1 launches for {steps} steps")

    ptr.train_epoch(0)
    rel = np.abs(ptr.last_step_losses / losses0 - 1.0).max()
    print(f"  {name} epoch 0 vs the backend: xla trainer: per-step max rel {rel:.2e} "
          f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
    if not rel <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"{name}: epoch 0 kernel and plain trainers differ by rel {rel}")

    tk.fused_render_fwd_pe.launches = 0
    after = ktr.evaluate()
    eval_launches = tk.fused_render_fwd_pe.launches
    print(f"  {name} evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after "
          f"{steps} steps, ssim {after['ssim']:.5f}, {eval_ms(ktr)}, "
          f"{eval_launches} launches for {n_chunks} chunks", flush=True)
    if eval_launches != n_chunks:
        raise RuntimeError(f"{name}: eval launched kernel 2 {eval_launches} times")
    if name != "lora.yaml" and not after["psnr"] > psnr0:
        raise RuntimeError(f"{name}: psnr after training {after['psnr']} <= at init {psnr0}")

    ptr.model.load_state_dict(ktr.model.state_dict())
    got, want = ktr.render_views(test.poses), ptr.render_views(test.poses)
    errs = {out: float(np.abs(g - w).max()) for g, w, out in zip(got, want, ("rgb", "depth", "acc"))}
    print(f"  {name} views vs the plain pipeline (trained weights): max abs err " + ", ".join(
        f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
    if not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items()):
        raise RuntimeError(f"{name}: kernel-rendered views disagree with the plain pipeline {errs}")

    # the kernels against their plain versions at the trainer's own shapes
    out = dict(launches=launches, eval_launches=eval_launches, step_ms=step_ms, fd=fd, d=d,
               psnr0=psnr0, psnr=after["psnr"], extract_s=extract_s, trainer=ktr)
    last = len(cfg.phases) - 1
    a, o = main_path_train_args(ktr, last, device)
    if a[-1][0].shape[0] != d or a[1].shape[1] != fd:
        raise RuntimeError(f"{name}: kernel 1 ran at D {a[-1][0].shape[0]}")
    R, S = a[2].shape
    out["train_err"] = compare_train(f"{name} kernel 1 at the step's {R}x{S}, D {d}",
                                     tt.fused_train_objective(*a, **o),
                                     tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
    out["train_ms"] = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=20)
    args = main_path_fwd_pe_args(ktr, test.poses[0], device)
    out["fwd_err"] = compare(f"{name} kernel 2 at the eval chunk {args[2].shape[0]}x"
                             f"{args[2].shape[1]}, D {args[-1][0].shape[0]}",
                             tk.fused_render_fwd_pe(*args, use_feats=True),
                             tk.fused_render_fwd_pe_reference(*args, use_feats=True))
    pts = torch.rand((R * S, 3), device=device) * 3.0 - 1.5
    pf = ktr.feature_sampler(0)
    out["sampler_ms"] = cuda_ms(lambda: pf(pts), iters=20)
    print(f"  {name} at the step's shape: kernel 1 {out['train_ms']:.3f} ms, feature sampling of "
          f"{R * S} points {out['sampler_ms']:.3f} ms (CUDA events)", flush=True)
    if name == "dino_nerf.yaml":
        epoch = DINO_EPOCHS[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ktr.train_epoch(epoch)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        for with_cpu in (False, True):
            print_trace(f"{name} epoch {epoch} traced ({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                        trace_epoch(ktr, epoch, with_cpu), untraced_ms)
    return out


def run_lora_kernel_width(device, tk, tt):
    """Kernel 1 at 512x64 and 1024x64 and kernel 2 at a 1024x64 eval chunk
    at the trunk-LoRA config's input width (pos_freq 10, view directions,
    64 features: 154 live columns, padded to D 160), random inputs,
    against their plain versions at the existing gates; CUDA-event times
    and bounds. Returns ``{kernel: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, bound32_ms, extra)}``."""
    rng = np.random.default_rng(160)
    fd, d = LORA_WIDTH
    rows, err = {}, 0.0
    train_ms = {}
    for R, label, kw in ((512, "white, 9 masked, reg, depth", dict(
            white_bkgd=True, ragged=9, reg_weight=0.01, depth_weight=0.1)),
            (1024, "", {}), (512, "", {})):
        a, o = random_train_args(rng, R, 64, 256, 8, device, feat_dim=fd, **kw)
        if a[-1][0].shape[0] != d:
            raise RuntimeError(f"the train kernel's input is {a[-1][0].shape[0]} wide, not {d}")
        err = max(err, compare_train(f"kernel 1 D {d}, {R}x64 {label}".rstrip(),
                                     tt.fused_train_objective(*a, **o),
                                     tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL))
        if not label:
            k_ms = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=20)
            p_ms = cuda_ms(lambda: tt.fused_train_objective_reference(*a, **o), iters=5)
            flops, nbytes = train_cost(a, o)
            b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
            b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
            train_ms[R] = (k_ms, p_ms, b_ms, b_by, b32_ms)
            print(f"  kernel 1 {R}x64 D {d}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms by {b_by} as 3xTF32 (share {b_ms / k_ms:.1%}; {b32_ms:.3f} ms "
                  f"fp32; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    rows["train_pe"] = (err, *train_ms[512], {"ms_at_1024x64": train_ms[1024][0],
                                              "plain_ms_at_1024x64": train_ms[1024][1],
                                              "bound_ms_at_1024x64": train_ms[1024][2]})

    args = random_fwd_pe_args(rng, 1024, 64, 256, 8, fd, device, pos_freq=10,
                              d_pad=tk.pe_width(90 + fd))
    if args[-1][0].shape[0] != d:
        raise RuntimeError(f"kernel 2's input is {args[-1][0].shape[0]} wide, not {d}")
    err = 0.0
    for white in (False, True):
        kw = dict(white_bkgd=white, use_feats=True)
        err = max(err, compare(f"kernel 2 D {d}, 1024x64 white_bkgd={white}",
                               tk.fused_render_fwd_pe(*args, **kw),
                               tk.fused_render_fwd_pe_reference(*args, **kw)))
    k_ms = cuda_ms(lambda: tk.fused_render_fwd_pe(*args, use_feats=True), iters=20)
    p_ms = cuda_ms(lambda: tk.fused_render_fwd_pe_reference(*args, use_feats=True), iters=10)
    flops, nbytes = fwd_pe_cost(args, use_feats=True)
    b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
    b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
    rows["fwd_pe"] = (err, k_ms, p_ms, b_ms, b_by, b32_ms, {})
    print(f"  kernel 2 1024x64 D {d}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms by {b_by} as 3xTF32 (share {b_ms / k_ms:.1%}; {b32_ms:.3f} ms fp32; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    return rows


def lora_trunk_configs():
    """``experiments/lora_nerf_trunk.yaml`` through the port's ``load_config``
    as it stands, and the config the slice trains: the same with
    ``nerf_model.sigma_bias: 0.1``, the repo's live start (the file has no
    sigma bias, and its seed-0 init sits in the zero-gradient dead basin:
    the slice reports the probe of the file as it stands)."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config

    cfg = load_config(os.path.join(ROOT, "experiments", LORA_TRUNK_CONFIG))
    n, o, d = cfg.nerf, cfg.optimizer, cfg.dino
    widths = (n.hidden_dim, n.num_layers, n.pos_freq, n.use_viewdirs, n.lora_rank, n.lora_alpha,
              d.model_type, d.output_dim, o.lora_only_after_epoch, cfg.data.resolution,
              cfg.rendering.chunk_size, n.sigma_bias)
    if widths != (256, 8, 10, True, 4, 16.0, "single_scale", LORA_WIDTH[0], 51, 128, 2048, None):
        raise RuntimeError(f"{LORA_TRUNK_CONFIG}: widths {widths}")
    live = config_from_dict({**cfg.raw, "nerf_model": {**cfg.raw["nerf_model"],
                                                       "sigma_bias": 0.1}})
    return cfg, live


def run_lora_trunk_slice(train, test, device, tk, tt):
    """``lora_nerf_trunk.yaml`` at full width (8x256 trunk with rank-4 LoRA
    on every layer, 64-wide single-scale features of the ViT-B/14 extractor
    on the card, D 160): eval at init (kernel 2 with the merged weights);
    ``train_epoch`` at LORA_EPOCHS, every step launching kernel 1 once, the
    freeze at epoch 51 (a fresh optimizer over the LoRA pairs: every base
    weight and head bit-equal after it, every ``lora_b`` moved); epoch 0
    against a ``backend: xla`` twin; the freeze taken by a kernel trainer
    and an ``xla`` trainer that both start at epoch 51; PSNR rising; the
    trained views against the plain pipeline; kernels 1 and 2 against their
    plain versions at the trainer's step and eval-chunk shapes; one
    phase-2 epoch traced. Returns a dict of the numbers and the trainer."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.models.lora import lora_label_fn
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    as_is, cfg = lora_trunk_configs()
    fd, d = LORA_WIDTH
    if tk.pe_width(tk.pe_layout(10, 4, True, fd)[3]) != d:
        raise RuntimeError("the LoRA config's input is not padded to D 160")
    feats = _precompute_features(cfg, train, device)
    if feats.shape != (N_TRAIN_VIEWS, 9, 9, fd) or not np.isfinite(feats).all():
        raise RuntimeError(f"feature maps {feats.shape}")
    probe = Trainer(as_is, train, test, device=device, dino_features=feats).dead_sigma_probe()
    print(f"  {LORA_TRUNK_CONFIG} as it stands (no sigma_bias, seed {as_is.seed}): dead-sigma "
          f"probe at init {probe:.3e}; the slice trains it with nerf_model.sigma_bias: 0.1",
          flush=True)

    ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
    xla = lambda c: config_from_dict({**c.raw, "rendering": {**c.raw["rendering"],
                                                             "backend": "xla"}})
    ptr = Trainer(xla(cfg), train, test, device=device, dino_features=feats)
    if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
        raise RuntimeError(f"paths {ktr.kernel_path}, {ptr.kernel_path}")
    n_chunks = -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    tk.fused_render_fwd_pe.launches = 0
    psnr0 = ktr.evaluate()["psnr"]
    if tk.fused_render_fwd_pe.launches != n_chunks:
        raise RuntimeError(f"eval {tk.fused_render_fwd_pe.launches} launches, {n_chunks} chunks")
    for e in LORA_EPOCHS:
        ktr.phase_data(ktr._phase_index(e))

    boundary = cfg.optimizer.lora_only_after_epoch
    frozen = lambda tr: {k: v.clone() for k, v in tr.model.state_dict().items()
                         if lora_label_fn(k) == "base"}

    def check_frozen(tr, before, label):
        state = tr.model.state_dict()
        moved = [k for k, v in before.items() if not torch.equal(state[k], v)]
        if moved:
            raise RuntimeError(f"{label}: base or head parameters moved after the freeze: {moved}")

    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    steps, out = 0, {}
    for e in LORA_EPOCHS:
        if e == boundary:
            before = frozen(ktr)
            lora_b = {k: v.clone() for k, v in ktr.model.state_dict().items()
                      if k.endswith("lora_b")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ktr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = len(ktr.last_step_losses)
        steps += n
        if e == 0:
            out["losses0"] = ktr.last_step_losses.copy()
        p = cfg.phase_for_epoch(e)
        pd = ktr.phase_data(ktr._phase_index(e))
        out["step_ms"] = sec / n * 1e3
        n_opt = sum(len(g["params"]) for g in ktr.optimizer.param_groups)
        print(f"  epoch {e} ({pd.H}x{pd.W}, {min(p.batch_size, pd.rays_o.shape[1])} rays x "
              f"{p.n_samples} samples per step): loss {loss:.6f}, {n} steps, {sec:.3f} s, "
              f"{out['step_ms']:.3f} ms/step, optimizer over {n_opt} tensors", flush=True)
        if not np.isfinite(ktr.last_step_losses).all():
            raise RuntimeError(f"epoch {e}: non-finite losses")
        if e == boundary + 1:
            check_frozen(ktr, before, f"epochs {boundary}-{e}")
            still = [k for k, v in lora_b.items() if torch.equal(ktr.model.state_dict()[k], v)]
            if still:
                raise RuntimeError(f"lora_b did not move across the freeze: {still}")
            print(f"  freeze: {len(before)} base and head tensors bit-equal across epochs "
                  f"{boundary}-{e}, all {len(lora_b)} lora_b moved", flush=True)
    out["launches"] = tt.fused_train_objective.launches["train_pe"]
    print(f"  launches: kernel 1 {out['launches']} for {steps} steps", flush=True)
    if out["launches"] != steps:
        raise RuntimeError(f"{out['launches']} kernel-1 launches for {steps} steps")
    check_frozen(ktr, before, f"epochs {boundary}-{LORA_EPOCHS[-1]}")

    ptr.train_epoch(0)
    rel = np.abs(ptr.last_step_losses / out["losses0"] - 1.0).max()
    print(f"  epoch 0 vs the backend: xla twin: per-step max rel {rel:.2e} "
          f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
    if not rel <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"epoch 0: kernel and plain trainers differ by rel {rel}")
    twins = [Trainer(c, train, test, device=device, dino_features=feats) for c in (cfg, xla(cfg))]
    inits = [frozen(t) for t in twins]
    for t in twins:
        t.train_epoch(boundary)
    rel = np.abs(twins[1].last_step_losses / twins[0].last_step_losses - 1.0).max()
    print(f"  the freeze as the first call (epoch {boundary}, {len(twins[0].last_step_losses)} "
          f"steps), kernel trainer vs xla trainer: per-step max rel {rel:.2e} "
          f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
    if not (rel <= TRAIN_LOSS_RTOL and all(t._lora_only_active for t in twins)):
        raise RuntimeError(f"the freeze: kernel and plain trainers differ by rel {rel}")
    for t, init in zip(twins, inits):
        check_frozen(t, init, f"epoch {boundary} as the first call")
    del twins

    tk.fused_render_fwd_pe.launches = 0
    after = ktr.evaluate()
    out["eval_launches"] = tk.fused_render_fwd_pe.launches
    print(f"  evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after {steps} steps, "
          f"ssim {after['ssim']:.5f}, {eval_ms(ktr)}, "
          f"{out['eval_launches']} launches for {n_chunks} chunks", flush=True)
    if out["eval_launches"] != n_chunks:
        raise RuntimeError(f"eval launched kernel 2 {out['eval_launches']} times")
    if not after["psnr"] > psnr0:
        raise RuntimeError(f"psnr after training {after['psnr']} <= at init {psnr0}")

    ptr.model.load_state_dict(ktr.model.state_dict())
    got, want = ktr.render_views(test.poses), ptr.render_views(test.poses)
    errs = {o: float(np.abs(g - w).max()) for g, w, o in zip(got, want, ("rgb", "depth", "acc"))}
    print("  views vs the plain pipeline (trained weights): max abs err " + ", ".join(
        f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
    if not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items()):
        raise RuntimeError(f"kernel-rendered views disagree with the plain pipeline {errs}")

    a, o = main_path_train_args(ktr, len(cfg.phases) - 1, device)
    R, S = a[2].shape
    if a[-1][0].shape[0] != d:
        raise RuntimeError(f"kernel 1 ran at D {a[-1][0].shape[0]}")
    out["train_err"] = compare_train(f"kernel 1 at the step's {R}x{S}, D {d}, merged weights",
                                     tt.fused_train_objective(*a, **o),
                                     tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
    out["train_ms"] = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=20)
    args = main_path_fwd_pe_args(ktr, test.poses[0], device)
    out["fwd_err"] = compare(f"kernel 2 at the eval chunk {args[2].shape[0]}x{args[2].shape[1]}, "
                             f"D {args[-1][0].shape[0]}, merged weights",
                             tk.fused_render_fwd_pe(*args, use_feats=True),
                             tk.fused_render_fwd_pe_reference(*args, use_feats=True))
    out["fwd_ms"] = cuda_ms(lambda: tk.fused_render_fwd_pe(*args, use_feats=True), iters=20)
    print(f"  at the trainer's shapes: kernel 1 {R}x{S} {out['train_ms']:.3f} ms, kernel 2 "
          f"{args[2].shape[0]}x{args[2].shape[1]} {out['fwd_ms']:.3f} ms (CUDA events)",
          flush=True)
    epoch = LORA_EPOCHS[-1] + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ktr.train_epoch(epoch)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    print_trace(f"epoch {epoch} traced (CUDA only)", trace_epoch(ktr, epoch, False), untraced_ms)
    out.update(psnr0=psnr0, psnr=after["psnr"], trainer=ktr, cfg=cfg, feats=feats, epoch=epoch)
    return out


def timed(label, kernel_fn, plain_fn, flops, nbytes, iters=10, plain_iters=3):
    """CUDA-event times of a kernel and its plain version, the 3xTF32 bound
    of ``flops`` / ``nbytes`` and its share, printed. Returns ``(ms,
    plain_ms, bound_ms, bound_by, bound32_ms)``."""
    k_ms = cuda_ms(kernel_fn, iters=iters)
    p_ms = cuda_ms(plain_fn, iters=plain_iters)
    b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
    b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
    print(f"  {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} "
          f"as 3xTF32 (share {b_ms / k_ms:.1%}; {b32_ms:.3f} ms fp32; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return k_ms, p_ms, b_ms, b_by, b32_ms


def flat_objective(r):
    return (r[0], *r[1])


def run_script_kernel_widths(device, tk, tt):
    """The five kernels at the script recipes' widths, random inputs with
    768-wide features, against their plain versions at the existing gates:
    kernel 1 at D 832 and 864 (1024x32 and 4096x64, the recipes' 32x32 and
    64x64 full-image steps), kernel 2 at D 832 and 864 (a 2048x64 eval
    chunk), kernels 4, 3 and 5 from a 896-wide x (512x64); second calls bit
    for bit; CUDA-event times, bounds on the live columns (831 / 858) and
    shares. Returns ``{row name: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, bound32_ms, extra)}``."""
    rng = np.random.default_rng(SCRIPT_FD)
    rows = {}
    for viewdirs, (x_dim, d) in SCRIPT_WIDTHS.items():
        err, times = 0.0, {}
        for R, S, kw in ((1024, 32, {}), (4096, 64, {}),
                         (1024, 32, dict(white_bkgd=True, ragged=9, reg_weight=0.01,
                                         depth_weight=0.1))):
            a, o = random_train_args(rng, R, S, 256, 8, device, feat_dim=SCRIPT_FD,
                                     use_viewdirs=viewdirs, **kw)
            if a[-1][0].shape[0] != d:
                raise RuntimeError(f"kernel 1's input is {a[-1][0].shape[0]} wide, not {d}")
            label = f"kernel 1 D {d}, {R}x{S}" + (" white, 9 masked, reg, depth" if kw else "")
            got = tt.fused_train_objective(*a, **o)
            check_bit_equal(label, flat_objective(got),
                            flat_objective(tt.fused_train_objective(*a, **o)))
            err = max(err, compare_train(label, got, tt.fused_train_objective_reference(*a, **o),
                                         TRAIN_GRAD_TOL))
            if torch.count_nonzero(got[1][0][x_dim:]):
                raise RuntimeError(f"{label}: the pad rows of w0 got a gradient")
            if not kw:
                times[(R, S)] = timed(f"kernel 1 {R}x{S} D {d}",
                                      lambda: tt.fused_train_objective(*a, **o),
                                      lambda: tt.fused_train_objective_reference(*a, **o),
                                      *train_cost(a, o), iters=10 if R == 1024 else 5,
                                      plain_iters=3 if R == 1024 else 2)
            del got
        small = times[(1024, 32)]
        rows[f"train_pe_script_d{d}"] = (err, *times[(4096, 64)], {
            "shape": "4096x64", "ms_at_1024x32": small[0], "plain_ms_at_1024x32": small[1],
            "bound_ms_at_1024x32": small[2]})

        args = random_fwd_pe_args(rng, 2048, 64, 256, 8, SCRIPT_FD, device, d_pad=d,
                                  use_viewdirs=viewdirs)
        err = 0.0
        for white in (False, True):
            kw = dict(white_bkgd=white, use_feats=True)
            got = tk.fused_render_fwd_pe(*args, **kw)
            check_bit_equal(f"kernel 2 D {d}, 2048x64 white_bkgd={white}", got,
                            tk.fused_render_fwd_pe(*args, **kw))
            err = max(err, compare(f"kernel 2 D {d}, 2048x64 white_bkgd={white}", got,
                                   tk.fused_render_fwd_pe_reference(*args, **kw)))
        rows[f"fwd_pe_script_d{d}"] = (err, *timed(
            f"kernel 2 2048x64 D {d}", lambda: tk.fused_render_fwd_pe(*args, use_feats=True),
            lambda: tk.fused_render_fwd_pe_reference(*args, use_feats=True),
            *fwd_pe_cost(args, use_feats=True), iters=20, plain_iters=5), {"shape": "2048x64"})

    (x, z, dnorm, packed), x_dim = random_render_args(rng, 512, 64, 256, 8, device,
                                                      feat_dim=SCRIPT_FD)
    if x.shape[1] != SCRIPT_X or x_dim != SCRIPT_WIDTHS[True][0]:
        raise RuntimeError(f"the encoded x is {x.shape[1]} wide ({x_dim} live)")
    fx = (x, z, dnorm, packed)
    got = tk.fused_render_fwd(*fx)
    check_bit_equal(f"kernel 4 x {SCRIPT_X}, 512x64", got, tk.fused_render_fwd(*fx))
    err = compare(f"kernel 4 x {SCRIPT_X}, 512x64", got, tk.fused_render_reference(*fx))
    rows[f"fwd_d{SCRIPT_X}"] = (err, *timed(
        f"kernel 4 512x64 x {SCRIPT_X}", lambda: tk.fused_render_fwd(*fx),
        lambda: tk.fused_render_reference(*fx), *render_cost(fx, x_dim, backward=False),
        iters=20, plain_iters=5), {"shape": "512x64"})

    cot = random_cotangents(rng, 512, 64, device)
    got = tk.fused_render_bwd(*fx, *cot)
    check_bit_equal(f"kernel 3 x {SCRIPT_X}, 512x64", (got[0], *got[1]),
                    (lambda r: (r[0], *r[1]))(tk.fused_render_bwd(*fx, *cot)))
    err = compare_vjp(f"kernel 3 x {SCRIPT_X}, 512x64", got,
                      tk.fused_render_bwd_reference(*fx, *cot), TRAIN_GRAD_TOL)
    if torch.count_nonzero(got[0][:, x_dim:]) or torch.count_nonzero(got[1][0][x_dim:]):
        raise RuntimeError("kernel 3: the pad columns of x got a cotangent or w0 a gradient")
    rows[f"render_bwd_d{SCRIPT_X}"] = (err, *timed(
        f"kernel 3 512x64 x {SCRIPT_X}", lambda: tk.fused_render_bwd(*fx, *cot),
        lambda: tk.fused_render_bwd_reference(*fx, *cot), *render_cost(fx, x_dim, backward=True),
        iters=10, plain_iters=3), {"shape": "512x64"})

    a, o = random_train_args(rng, 512, 64, 256, 8, device, feat_dim=SCRIPT_FD, inline_pe=False)
    if a[0].shape[1] != SCRIPT_X:
        raise RuntimeError(f"kernel 5's x is {a[0].shape[1]} wide")
    got = tt.fused_train_objective(*a, **o)
    check_bit_equal(f"kernel 5 x {SCRIPT_X}, 512x64", flat_objective(got),
                    flat_objective(tt.fused_train_objective(*a, **o)))
    err = compare_train(f"kernel 5 x {SCRIPT_X}, 512x64", got,
                        tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
    rows[f"train_d{SCRIPT_X}"] = (err, *timed(
        f"kernel 5 512x64 x {SCRIPT_X}", lambda: tt.fused_train_objective(*a, **o),
        lambda: tt.fused_train_objective_reference(*a, **o), *train_cost(a, o, x_dim=x_dim),
        iters=10, plain_iters=3), {"shape": "512x64"})
    return rows


def run_x_width_steps(trainer, device, tk, tt):
    """On a script trainer with view directions (its MLP input encoded 896
    wide): one differentiable render step through ``fused_render_rays(
    forward_only=False)`` (kernel 4, then kernel 3 for the gradients) and
    one ``fused_train_loss_grad(inline_pe=False)`` step (kernel 5), on 512
    rays of train view 0 at the last phase's samples with that view's
    features; each kernel launched once, the two losses (the same masked
    MSE) within rel 1e-4. Returns the launches by kernel."""
    from nerf_fewshot_tpu_torch.render.fused import fused_render_rays

    cfg, n = trainer.cfg, trainer.cfg.nerf
    last = len(cfg.phases) - 1
    pd = trainer.phase_data(last)
    idx = torch.arange(512, device=device) * (pd.rays_o.shape[1] // 512)
    ro, rd, tgt = pd.rays_o[0][idx], pd.rays_d[0][idx], pd.targets[0][idx]
    settings = trainer._render_settings(cfg.phases[last].n_samples, training=False)
    pf = trainer.feature_sampler(0)
    before = (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches,
              tt.fused_train_objective.launches["train_x"])
    params = dict(trainer.model.named_parameters())
    out = fused_render_rays(params, ro, rd, settings, n.pos_freq, n.dir_freq, n.num_layers,
                            n.hidden_dim, use_viewdirs=n.use_viewdirs, device=device,
                            point_features_fn=pf, lora_alpha=n.lora_alpha)
    loss4 = torch.mean((out.rgb - tgt) ** 2)
    grads = torch.autograd.grad(loss4, list(params.values()))
    loss5, _ = tt.fused_train_loss_grad(
        trainer.model, ro, rd, tgt, torch.ones(512, device=device), settings, n.pos_freq,
        n.dir_freq, n.num_layers, n.hidden_dim, use_viewdirs=n.use_viewdirs, inline_pe=False,
        point_features_fn=pf, lora_alpha=n.lora_alpha)
    torch.cuda.synchronize()
    launches = {"fwd": tk.fused_render_fwd.launches - before[0],
                "render_bwd": tk.fused_render_bwd.launches - before[1],
                "train_x": tt.fused_train_objective.launches["train_x"] - before[2]}
    rel = abs(loss4.item() / loss5.item() - 1.0)
    print(f"  x {SCRIPT_X} wide, 512x{settings.n_samples}: a differentiable render step (kernels "
          f"4 and 3) and an inline_pe=False step (kernel 5): launches {launches}, losses "
          f"{loss4.item():.6e} / {loss5.item():.6e} (rel {rel:.2e}, tol {TRAIN_LOSS_RTOL:.0e})",
          flush=True)
    if launches != {"fwd": 1, "render_bwd": 1, "train_x": 1} or not rel <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"the x-input kernels at {SCRIPT_X}: launches {launches}, rel {rel}")
    if not all(torch.isfinite(g).all() for g in grads):
        raise RuntimeError("kernel 3's gradients are not finite")
    return launches


def script_config(name):
    """``experiments/<name>`` through the port's ``load_config`` as it
    stands, its widths checked: the 8x256 trunk at pos_freq 10, the
    patch-embedding features (768, the scripts' projection with
    ``align_corners``), 5 views at 128x128, full-image steps, 2048-ray eval
    chunks."""
    from nerf_fewshot_tpu_torch.training.config import load_config

    cfg = load_config(os.path.join(ROOT, "experiments", name))
    n, d = cfg.nerf, cfg.dino
    widths = (n.hidden_dim, n.num_layers, n.pos_freq, d.model_type, d.output_dim, d.projection,
              d.align_corners, cfg.data.resolution, cfg.data.num_views, cfg.rendering.chunk_size)
    if widths != (256, 8, 10, "patch_embed", SCRIPT_FD, "script", True, 128, N_TRAIN_VIEWS, 2048):
        raise RuntimeError(f"{name}: widths {widths}")
    if any(p.batch_size != p.H * p.W for p in cfg.phases):
        raise RuntimeError(f"{name}: not full-image steps")
    return cfg


def run_script_slice(train, test, device, tk, tt):
    """The script recipes at full width on the synthetic scene, each file
    read by the port's ``load_config``: the patch-embedding extractor on the
    card (one (14, 14, 768) map per view); for each of SCRIPT_EPOCHS' files,
    eval at init through kernel 2 (one launch per 2048-ray chunk),
    ``train_epoch`` at its epochs (one launch of kernel 1 per full-image
    step; ``script_lora``'s base weights and heads bit-equal across the
    freeze, every ``lora_b`` moved), epoch 0 against a ``backend: xla``
    twin (rel 1e-4), PSNR rising, the trained views against the plain
    pipeline, kernels 1 and 2 and the feature sampler at the trainer's
    shapes; one 64x64 epoch traced; then ``script_baseline.yaml`` (no sigma
    bias) through ``fit`` for SCRIPT_DEAD_EPOCHS epochs, its dead-sigma
    epochs reported, not gated. Returns a dict of the numbers per file."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.models.lora import lora_label_fn
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfgs = {name: script_config(name) for name in (*SCRIPT_EPOCHS, SCRIPT_DEAD_CONFIG)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = _precompute_features(cfgs[SCRIPT_DEAD_CONFIG], train, device)
    extract_s = time.perf_counter() - t0
    print(f"  patch_embed extractor (224x224 PIL-free preprocessing, ViT-B/16 conv 3->768) -> "
          f"feature maps {tuple(feats.shape)} in {extract_s:.2f} s (build and {train.n_views} "
          f"views)", flush=True)
    if feats.shape != (N_TRAIN_VIEWS, 14, 14, SCRIPT_FD) or not np.isfinite(feats).all():
        raise RuntimeError(f"feature maps {feats.shape}")
    xla = lambda c: config_from_dict({**c.raw, "rendering": {**c.raw["rendering"],
                                                             "backend": "xla"}})
    any_cfg = cfgs[SCRIPT_DEAD_CONFIG]
    n_chunks = -(-N_TEST_VIEWS * any_cfg.data.resolution ** 2 // any_cfg.rendering.chunk_size)
    base = lambda tr: {k: v.clone() for k, v in tr.model.state_dict().items()
                       if lora_label_fn(k) == "base"}
    results = {}
    for name, epochs in SCRIPT_EPOCHS.items():
        cfg = cfgs[name]
        x_dim, d = SCRIPT_WIDTHS[cfg.nerf.use_viewdirs]
        ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
        probe = ktr.dead_sigma_probe()
        if probe <= 0.0:
            # the file's seed-0 init sits in the zero-gradient dead basin
            # (no sigma bias): train its live variant, as script_baseline_live
            # is to script_baseline, and say so
            cfg = config_from_dict({**cfg.raw, "nerf_model": {**cfg.raw["nerf_model"],
                                                              "sigma_bias": 0.1}})
            ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
        print(f"  {name}: dead-sigma probe at init {probe:.3e} as the file stands; trained with "
              f"nerf_model.sigma_bias {cfg.nerf.sigma_bias}", flush=True)
        ptr = Trainer(xla(cfg), train, test, device=device, dino_features=feats)
        if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
            raise RuntimeError(f"{name}: paths {ktr.kernel_path}, {ptr.kernel_path}")
        tk.fused_render_fwd_pe.launches = 0
        psnr0 = ktr.evaluate()["psnr"]
        if tk.fused_render_fwd_pe.launches != n_chunks:
            raise RuntimeError(f"{name}: eval {tk.fused_render_fwd_pe.launches} launches, "
                               f"{n_chunks} chunks")
        for e in epochs:
            ktr.phase_data(ktr._phase_index(e))
        boundary = cfg.optimizer.lora_only_after_epoch
        tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
        steps, out = 0, dict(d=d, psnr0=psnr0, extract_s=extract_s, probe_as_is=probe,
                             sigma_bias=cfg.nerf.sigma_bias)
        for e in epochs:
            if e == boundary:
                before = base(ktr)
                lora_b = {k: v.clone() for k, v in ktr.model.state_dict().items()
                          if k.endswith("lora_b")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = ktr.train_epoch(e)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = len(ktr.last_step_losses)
            steps += n
            if e == 0:
                losses0 = ktr.last_step_losses.copy()
            p, pd = cfg.phase_for_epoch(e), ktr.phase_data(ktr._phase_index(e))
            out["step_ms"] = sec / n * 1e3
            print(f"  {name} epoch {e} ({pd.H}x{pd.W}, {min(p.batch_size, pd.rays_o.shape[1])} "
                  f"rays x {p.n_samples} samples per step, D {d}): loss {loss:.6f}, {n} steps, "
                  f"{sec:.3f} s, {out['step_ms']:.3f} ms/step", flush=True)
            if not np.isfinite(ktr.last_step_losses).all():
                raise RuntimeError(f"{name} epoch {e}: non-finite losses")
            if boundary is not None and e == boundary + 1:
                state = ktr.model.state_dict()
                moved = [k for k, v in before.items() if not torch.equal(state[k], v)]
                still = [k for k, v in lora_b.items() if torch.equal(state[k], v)]
                if moved or still or not ktr._lora_only_active:
                    raise RuntimeError(f"{name}: across the freeze base moved {moved}, "
                                       f"lora_b still {still}")
                print(f"  {name} freeze: {len(before)} base and head tensors bit-equal across "
                      f"epochs {boundary}-{e}, all {len(lora_b)} lora_b moved", flush=True)
        out["launches"] = tt.fused_train_objective.launches["train_pe"]
        print(f"  {name} launches: kernel 1 {out['launches']} for {steps} steps", flush=True)
        if out["launches"] != steps:
            raise RuntimeError(f"{name}: {out['launches']} kernel-1 launches for {steps} steps")

        ptr.train_epoch(0)
        rel = np.abs(ptr.last_step_losses / losses0 - 1.0).max()
        print(f"  {name} epoch 0 vs the backend: xla twin: per-step max rel {rel:.2e} "
              f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
        if not rel <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"{name}: epoch 0 kernel and plain trainers differ by rel {rel}")

        tk.fused_render_fwd_pe.launches = 0
        after = ktr.evaluate()
        out.update(eval_launches=tk.fused_render_fwd_pe.launches, psnr=after["psnr"])
        print(f"  {name} evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after "
              f"{steps} steps, ssim {after['ssim']:.5f}, {eval_ms(ktr)}, "
              f"{out['eval_launches']} launches for {n_chunks} chunks", flush=True)
        if out["eval_launches"] != n_chunks:
            raise RuntimeError(f"{name}: eval launched kernel 2 {out['eval_launches']} times")
        if not after["psnr"] > psnr0:
            raise RuntimeError(f"{name}: psnr after training {after['psnr']} <= at init {psnr0}")

        ptr.model.load_state_dict(ktr.model.state_dict())
        got, want = ktr.render_views(test.poses), ptr.render_views(test.poses)
        errs = {o: float(np.abs(g - w).max())
                for g, w, o in zip(got, want, ("rgb", "depth", "acc"))}
        print(f"  {name} views vs the plain pipeline (trained weights): max abs err " + ", ".join(
            f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
        if not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items()):
            raise RuntimeError(f"{name}: kernel-rendered views disagree with the plain pipeline "
                               f"{errs}")
        del ptr, got, want

        a, o = main_path_train_args(ktr, len(cfg.phases) - 1, device)
        R, S = a[2].shape
        if a[-1][0].shape[0] != d or a[1].shape[1] != SCRIPT_FD:
            raise RuntimeError(f"{name}: kernel 1 ran at D {a[-1][0].shape[0]}")
        out["train_err"] = compare_train(f"{name} kernel 1 at the step's {R}x{S}, D {d}",
                                         tt.fused_train_objective(*a, **o),
                                         tt.fused_train_objective_reference(*a, **o),
                                         TRAIN_GRAD_TOL)
        out["train_ms"] = cuda_ms(lambda: tt.fused_train_objective(*a, **o), iters=5)
        args = main_path_fwd_pe_args(ktr, test.poses[0], device)
        out["fwd_err"] = compare(f"{name} kernel 2 at the eval chunk {args[2].shape[0]}x"
                                 f"{args[2].shape[1]}, D {args[-1][0].shape[0]}",
                                 tk.fused_render_fwd_pe(*args, use_feats=True),
                                 tk.fused_render_fwd_pe_reference(*args, use_feats=True))
        out["fwd_ms"] = cuda_ms(lambda: tk.fused_render_fwd_pe(*args, use_feats=True), iters=20)
        pts = torch.rand((R * S, 3), device=device) * 3.0 - 1.5
        pf = ktr.feature_sampler(0)
        out["sampler_ms"] = cuda_ms(lambda: pf(pts), iters=10)
        print(f"  {name} at the trainer's shapes: kernel 1 {R}x{S} {out['train_ms']:.3f} ms, "
              f"kernel 2 {args[2].shape[0]}x{args[2].shape[1]} {out['fwd_ms']:.3f} ms, feature "
              f"sampling of {R * S} points x {SCRIPT_FD} channels {out['sampler_ms']:.3f} ms "
              f"(CUDA events)", flush=True)
        del a, o, args
        if name == SCRIPT_TRACED:
            epoch = epochs[-1] + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ktr.train_epoch(epoch)
            torch.cuda.synchronize()
            untraced_ms = (time.perf_counter() - t0) * 1e3
            for with_cpu in (False, True):
                print_trace(f"{name} epoch {epoch} traced "
                            f"({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                            trace_epoch(ktr, epoch, with_cpu), untraced_ms)
            out["x_launches"] = run_x_width_steps(ktr, device, tk, tt)
        results[name] = out
        del ktr
        torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_script_")
    try:
        cfg = cfgs[SCRIPT_DEAD_CONFIG]
        cfg = config_from_dict({**cfg.raw, "output": {**cfg.raw["output"], "save_dir": tmp}})
        dtr = Trainer(cfg, train, test, device=device, dino_features=feats)
        probe = dtr.dead_sigma_probe()
        dtr.fit(SCRIPT_DEAD_EPOCHS)
        print(f"  {SCRIPT_DEAD_CONFIG} (no sigma bias, seed {cfg.seed}): probe at init "
              f"{probe:.3e}; after {SCRIPT_DEAD_EPOCHS} epochs through {dtr.kernel_path} "
              f"dead_sigma_epochs {dtr.dead_sigma_epochs}, probe {dtr.dead_sigma_probe():.3e} "
              f"(reported, not gated)", flush=True)
        results[SCRIPT_DEAD_CONFIG] = dict(dead_sigma_epochs=dtr.dead_sigma_epochs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


def run_reference_checkpoint(lora, train, test, device, tk, tmp):
    """The trained LoRA trainer's weights written as a reference PyTorch
    checkpoint (``layers.{i}.original`` / ``lora_A`` / ``lora_B``,
    ``sigma_out``, ``rgb_out`` under ``nerf_model_state_dict``), loaded into
    a fresh ``Trainer(device="cuda")``: its views through kernel 2 equal the
    first trainer's, bit for bit or within the view tolerances."""
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    ktr, cfg = lora["trainer"], lora["cfg"]
    state = {k: v.detach().cpu() for k, v in ktr.model.state_dict().items()}
    sd = {}
    for i in range(cfg.nerf.num_layers):
        for p in ("weight", "bias"):
            sd[f"layers.{i}.original.{p}"] = state[f"trunk.{i}.base.{p}"]
        sd[f"layers.{i}.lora_A.weight"] = state[f"trunk.{i}.lora_a"].T.contiguous()
        sd[f"layers.{i}.lora_B.weight"] = state[f"trunk.{i}.lora_b"].T.contiguous()
    for ours, ref in (("sigma_head", "sigma_out"), ("rgb_head", "rgb_out")):
        for p in ("weight", "bias"):
            sd[f"{ref}.{p}"] = state[f"{ours}.{p}"]
    path = os.path.join(tmp, "reference.pth")
    torch.save({"nerf_model_state_dict": sd, "epoch": lora["epoch"]}, path)
    fresh = Trainer(cfg, train, test, device=device, dino_features=lora["feats"])
    fresh.load(path)
    if fresh.epoch != lora["epoch"] + 1:
        raise RuntimeError(f"the loaded trainer is at epoch {fresh.epoch}")
    poses = test.poses[:2]
    tk.fused_render_fwd_pe.launches = 0
    got = fresh.render_views(poses)
    n_chunks = -(-len(poses) * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    if tk.fused_render_fwd_pe.launches != n_chunks or fresh.kernel_path != "kernel":
        raise RuntimeError(f"the loaded trainer's views: {tk.fused_render_fwd_pe.launches} "
                           f"kernel-2 launches for {n_chunks} chunks")
    want = ktr.render_views(poses)
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    errs = {o: float(np.abs(g - w).max()) for g, w, o in zip(got, want, ("rgb", "depth", "acc"))}
    print(f"  {path.rsplit(os.sep, 1)[-1]} ({len(sd)} tensors, epoch {lora['epoch']}) into a "
          f"fresh trainer: epoch {fresh.epoch}, views through kernel 2 "
          f"{'bit-equal' if equal else 'max abs err ' + str(errs)} to the trainer that wrote it",
          flush=True)
    if not equal and any(v > TOL[k] for k, v in errs.items()):
        raise RuntimeError(f"the reference checkpoint renders differently: {errs}")


def run_module_and_skip_slice(train, test, device, tk, tt):
    """``multiscale.yaml`` with ``nerf_model.arch: module`` (the reference's
    train_multiscale.py surface: ``NeRFWithDINO``, 128-wide multi-scale
    features, ``invalid_fill: mean``, the full-resolution focal) and
    ``baseline.yaml`` with ``skip_layers: [4]`` on the card: the plain path
    with the JAX trainer's reason, no kernel launched, ``backend: fused``
    raising; the module config trains at MODULE_EPOCHS and evaluates (PSNR
    above init), the skip config trains one epoch."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    raw = load_config(os.path.join(ROOT, "experiments", "multiscale.yaml")).raw
    module = config_from_dict({**raw, "nerf_model": {**raw["nerf_model"], "arch": "module"}})
    skip = config_from_dict({**BASELINE_CONFIG, "nerf_model": {
        **BASELINE_CONFIG["nerf_model"], "skip_layers": [4]}})
    fused = lambda c: config_from_dict({**c.raw, "rendering": {**c.raw["rendering"],
                                                               "backend": "fused"}})
    d = module.dino
    if (d.output_dim, d.invalid_fill, module.focal_scaling) != (128, "mean", False):
        raise RuntimeError(f"module config: {d.output_dim}, {d.invalid_fill}, "
                           f"{module.focal_scaling}")
    feats = _precompute_features(module, train, device)
    reasons = {"module": "arch=module (NeRFWithDINO) has no kernel packing",
               "skip": ("skip_layers=[4] — the fused kernels require a uniform trunk "
                        "(pack_params assumes hidden→hidden layers)")}
    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    for k in (tk.fused_render_fwd_pe, tk.fused_render_fwd, tk.fused_render_bwd):
        k.launches = 0
    for name, cfg in (("module", module), ("skip", skip)):
        tr = Trainer(cfg, train, test, device=device, dino_features=feats)
        if tr._use_fused() or (tr.kernel_path, tr.kernel_path_reason) != ("plain", reasons[name]):
            raise RuntimeError(f"{name}: path {tr.kernel_path} ({tr.kernel_path_reason})")
        psnr0 = tr.evaluate()["psnr"] if name == "module" else None
        for e in MODULE_EPOCHS if name == "module" else (0,):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.train_epoch(e)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = len(tr.last_step_losses)
            p = cfg.phase_for_epoch(e)
            print(f"  {name} epoch {e} ({p.H}x{p.W}, {p.n_samples} samples): loss {loss:.6f}, "
                  f"{n} steps, {sec:.3f} s, {sec / n * 1e3:.3f} ms/step, kernel_path "
                  f"{tr.kernel_path} ({tr.kernel_path_reason})", flush=True)
            if not np.isfinite(tr.last_step_losses).all():
                raise RuntimeError(f"{name} epoch {e}: non-finite losses")
        if name == "module":
            after = tr.evaluate()
            print(f"  module evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB "
                  f"after, ssim {after['ssim']:.5f}", flush=True)
            if not (np.isfinite(after["ssim"]) and after["psnr"] > psnr0):
                raise RuntimeError(f"module: psnr {after['psnr']} after, {psnr0} at init")
        try:
            Trainer(fused(cfg), train, device=device, dino_features=feats).train_epoch(0)
        except ValueError as err:
            print(f"  {name}, backend fused: raises ({err})", flush=True)
        else:
            raise RuntimeError(f"{name} trained under backend: fused")
    counts = (tt.fused_train_objective.launches, tk.fused_render_fwd_pe.launches,
              tk.fused_render_fwd.launches, tk.fused_render_bwd.launches)
    print(f"  kernel launches on these paths: {counts}", flush=True)
    if counts != ({"train_pe": 0, "train_x": 0}, 0, 0, 0):
        raise RuntimeError(f"the plain path launched a kernel: {counts}")


def run_cli(tmp):
    """``python -m nerf_fewshot_tpu_torch.cli train --config
    experiments/dino_nerf.yaml --synthetic --epochs 2`` in a fresh process
    (its ``save_dir`` is relative: the run's working directory is ``tmp``):
    exit 0, ``final.ckpt`` written, the summary JSON with the kernel path."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "nerf_fewshot_tpu_torch.cli", "train", "--config",
           os.path.join(ROOT, "experiments", "dino_nerf.yaml"), "--synthetic", "--epochs", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  cli train dino_nerf.yaml --synthetic --epochs 2: exit 0 in {sec:.2f} s; summary "
          f"{json.dumps(summary)}", flush=True)
    if set(summary) - {"dead_sigma_epochs"} != {"final_metrics", "best_psnr"}:
        raise RuntimeError(f"the CLI's summary keys {sorted(summary)}")
    if summary["final_metrics"].get("kernel_path") != "kernel":
        raise RuntimeError("the CLI did not train on the kernel path")
    if not os.path.exists(os.path.join(tmp, "results", "dino_nerf_lego", "final.ckpt")):
        raise RuntimeError("the CLI wrote no final.ckpt")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.render import cuda_build
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.tools.f64_cases import objective_f64, to_f64
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
                if any(w in line for w in ("Used", "Compiling entry", "spill", "serializ")):
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
        got = tk.fused_render_fwd_pe(*args)
        check_bit_equal("kernel 2", got, tk.fused_render_fwd_pe(*args))
        max_err = compare("main path 2048x64, 8x256", got, tk.fused_render_fwd_pe_reference(*args))
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
        bound_ms, bound_by, _ = bounds(flops, nbytes, tensor_cores=True)
        bound32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
        print(f"  main path: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms by {bound_by} as 3xTF32 (share {bound_ms / kernel_ms:.1%}; "
              f"{bound32_ms:.3f} ms at the fp32 CUDA-core peak; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); kernel at {flops / kernel_ms / 1e9:.2f} TFLOP/s",
              flush=True)
        print_launch_times("kernel 2 2048x64", lambda: tk.fused_render_fwd_pe(*args))

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
            b_ms, b_by, _ = bounds(flops, nbytes, tensor_cores=True)
            b32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
            train_ms[(name, i)] = (k_ms, p_ms, b_ms, b_by, b32_ms)
            R, S = a[2].shape
            print(f"  {name} phase {i} {R}x{S}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms by {b_by} as 3xTF32 ({b32_ms:.3f} ms at the fp32 CUDA-core "
                  f"peak; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
                  f"{flops / k_ms / 1e9:.2f} TFLOP/s", flush=True)
        a, o = timing[("train_pe", len(cfg.phases) - 1)]
        R, S = a[2].shape
        print_launch_times(f"train_pe {R}x{S}", lambda: tt.fused_train_objective(*a, **o))
        exact = objective_f64(a, o)
        f64_report(f"train_pe {R}x{S}", (lambda r: (r[0], *r[1]))(tt.fused_train_objective(*a, **o)),
                   (lambda r: (r[0], *r[1]))(tt.fused_train_objective_reference(*a, **o)),
                   (exact[0], *exact[1]))

    with phase("render kernel 4 vs plain"):
        fx_args = main_path_fwd_x_args(trainer, test.poses[0], device)
        got = tk.fused_render_fwd(*fx_args)
        check_bit_equal("kernel 4", got, tk.fused_render_fwd(*fx_args))
        fwd_err = compare("main path 2048x64, 8x256, x 128 wide", got,
                          tk.fused_render_reference(*fx_args))
        rng = np.random.default_rng(cfg.seed)
        for S, white, fd in ((128, False, 0), (64, True, 0), (64, False, 64)):
            a, _ = random_render_args(rng, 2048, S, 256, 8, device, feat_dim=fd)
            fwd_err = max(fwd_err, compare(
                f"S={S} white_bkgd={white} Fd={fd} (x {a[0].shape[1]} wide)",
                tk.fused_render_fwd(*a, white_bkgd=white),
                tk.fused_render_reference(*a, white_bkgd=white)))
        torch.cuda.synchronize()
        fwd_ms = cuda_ms(lambda: tk.fused_render_fwd(*fx_args), iters=20)
        fwd_plain_ms = cuda_ms(lambda: tk.fused_render_reference(*fx_args), iters=10)
        flops, nbytes = render_cost(fx_args, 90, backward=False)
        fwd_bound_ms, fwd_bound_by, _ = bounds(flops, nbytes, tensor_cores=True)
        fwd_bound32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
        print(f"  main path: kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, bound "
              f"{fwd_bound_ms:.3f} ms by {fwd_bound_by} as 3xTF32 (share "
              f"{fwd_bound_ms / fwd_ms:.1%}; {fwd_bound32_ms:.3f} ms at the fp32 CUDA-core peak; "
              f"{flops / 1e9:.1f} GFLOP on the 90 real input columns, {nbytes / 1e6:.2f} MB); "
              f"kernel at {flops / fwd_ms / 1e9:.2f} TFLOP/s", flush=True)
        print_launch_times("kernel 4 2048x64", lambda: tk.fused_render_fwd(*fx_args))

    with phase("render VJP kernel 3 vs plain"):
        (bw_args, bw_cot) = main_path_render_bwd_args(trainer, device)
        got = tk.fused_render_bwd(*bw_args, *bw_cot)
        again = tk.fused_render_bwd(*bw_args, *bw_cot)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip((got[0], *got[1]), (again[0], *again[1]))):
            raise RuntimeError("kernel 3: two calls on the same inputs differ")
        print("  two calls agree bit for bit", flush=True)
        bwd_err = compare_vjp("main path 512x64, 8x256, baseline init", got,
                              tk.fused_render_bwd_reference(*bw_args, *bw_cot), TRAIN_GRAD_TOL)
        rng = np.random.default_rng(cfg.seed)
        for label, kw, white, tol in (
                ("512x64 white, Fd 64 (x 256 wide)", dict(feat_dim=64), True, TRAIN_GRAD_TOL),
                ("512x128", {}, False, TRAIN_GRAD_TOL),
                ("512x64 sigma_bias 5.0", dict(sigma_bias=5.0), False,
                 TRAIN_GRAD_TOL_SATURATED)):
            S = 128 if "x128" in label else 64
            a, _ = random_render_args(rng, 512, S, 256, 8, device, **kw)
            cot = random_cotangents(rng, 512, S, device)
            bwd_err = max(bwd_err, compare_vjp(
                label, tk.fused_render_bwd(*a, *cot, white_bkgd=white),
                tk.fused_render_bwd_reference(*a, *cot, white_bkgd=white), tol))
        torch.cuda.synchronize()
        bwd_ms = cuda_ms(lambda: tk.fused_render_bwd(*bw_args, *bw_cot), iters=20)
        bwd_plain_ms = cuda_ms(lambda: tk.fused_render_bwd_reference(*bw_args, *bw_cot), iters=5)
        flops, nbytes = render_cost(bw_args, 90, backward=True)
        bwd_bound_ms, bwd_bound_by, _ = bounds(flops, nbytes, tensor_cores=True)
        bwd_bound32_ms, _, _ = bounds(flops, nbytes, tensor_cores=False)
        print(f"  main path: kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms, bound "
              f"{bwd_bound_ms:.3f} ms by {bwd_bound_by} as 3xTF32 ({bwd_bound32_ms:.3f} ms at the "
              f"fp32 CUDA-core peak; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
              f"{flops / bwd_ms / 1e9:.2f} TFLOP/s", flush=True)
        print_launch_times("kernel 3 512x64", lambda: tk.fused_render_bwd(*bw_args, *bw_cot))
        exact = tk.fused_render_bwd_reference(*to_f64(bw_args), *to_f64(bw_cot))
        f64_report("kernel 3 at 512x64", (lambda r: (r[0], *r[1]))(got),
                   (lambda r: (r[0], *r[1]))(tk.fused_render_bwd_reference(*bw_args, *bw_cot)),
                   (exact[0], *exact[1]))

    with phase("differentiable render steps"):
        fwd_launches, bwd_launches = run_render_steps(cfg, trainer, device, tk)

    with phase("slice"):
        trainer.render_views(test.poses[:1])  # warm the host path
        tk.fused_render_fwd_pe.launches = 0
        metrics = trainer.evaluate()
        launches = tk.fused_render_fwd_pe.launches
        n_rays = N_TEST_VIEWS * res * res
        n_chunks = -(-n_rays // cfg.rendering.chunk_size)
        print(f"  evaluate: psnr {metrics['psnr']:.4f} dB, ssim {metrics['ssim']:.5f}, "
              f"{n_rays / trainer.eval_seconds['render']:.0f} rays/s, {eval_ms(trainer)}, "
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
            train_launches, x_launches, trained = run_train_slice(
                cfg, train, test, device, tmp, metrics["psnr"], tt)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    with phase("evaluate baseline.yaml"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
        try:
            eval_launches = {"baseline.yaml": run_evaluate_phase(
                "baseline.yaml", trained, train, test, device, tk, smi, tmp)}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del trained

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
            print_trace(f"epoch {epoch} traced ({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                        trace_epoch(trainer, epoch, with_cpu), untraced_ms)

    with phase("hierarchical train slice"):
        x_launches_hier = run_hierarchical_slice(train, test, device, tk, tt)

    with phase("repair check"):
        run_repair_check(train, device, tk, tt)

    with phase("DINO kernel widths"):
        dino_rows = run_dino_kernel_widths(device, tk, tt)

    dino = {}
    for name in DINO_CONFIGS:
        with phase(f"DINO slice {name}"):
            dino[name] = run_dino_slice(name, train, test, device, tk, tt)
        if name == "dino_nerf.yaml":
            with phase(f"evaluate {name}"):
                tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
                try:
                    eval_launches[name] = run_evaluate_phase(
                        name, dino[name]["trainer"], train, test, device, tk, smi, tmp)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        del dino[name]["trainer"]

    with phase("LoRA trunk kernel width"):
        lora_rows = run_lora_kernel_width(device, tk, tt)

    with phase(f"LoRA trunk slice {LORA_TRUNK_CONFIG}"):
        lora = run_lora_trunk_slice(train, test, device, tk, tt)

    with phase("reference checkpoint"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_pth_")
        try:
            run_reference_checkpoint(lora, train, test, device, tk, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del lora["trainer"]

    with phase("module and skip slice"):
        run_module_and_skip_slice(train, test, device, tk, tt)

    with phase("script kernel widths"):
        script_rows = run_script_kernel_widths(device, tk, tt)

    with phase("script slice"):
        script = run_script_slice(train, test, device, tk, tt)

    with phase("CLI"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        try:
            run_cli(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    last = len(cfg.phases) - 1

    def train_row(name, cu_line, launches):
        k_ms, p_ms, b_ms, b_by, b32_ms = train_ms[(name, last)]
        return {"name": name, "route": "cuda",
                "source": "nerf_fewshot_tpu_torch/csrc/train_pe.cu",
                "replaces": f"nerf_fewshot_tpu/render/train_kernel.py:{cu_line}",
                "launches": launches, "max_abs_err": train_err[name], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_rate": "3xTF32 at 495 TFLOP/s", "bound_fp32_ms": b32_ms,
                "library_ms": None}

    def dino_row(kernel, d, names):
        err, k_ms, p_ms, b_ms, b_by, b32_ms = dino_rows[(kernel, d)]
        train = kernel == "train_pe"
        row = {"name": f"{kernel}_dino_d{d}", "route": "cuda",
               "source": f"nerf_fewshot_tpu_torch/csrc/{kernel}.cu",
               "replaces": ("nerf_fewshot_tpu/render/train_kernel.py:343" if train
                            else "nerf_fewshot_tpu/render/kernels.py:251"),
               "shape": "512x64" if train else "1024x64", "configs": list(names),
               "launches": sum(dino[n]["launches" if train else "eval_launches"] for n in names)
               + (0 if train else sum(eval_launches.get(n, 0) for n in names)),
               "max_abs_err": max([err] + [dino[n]["train_err" if train else "fwd_err"]
                                           for n in names]),
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_rate": "3xTF32 at 495 TFLOP/s", "bound_fp32_ms": b32_ms,
               "library_ms": None}
        if train:
            row["ms_at_the_step_shape"] = {n: dino[n]["train_ms"] for n in names}
        else:
            row["configs"] += [f"cli evaluate {n}" for n in names if n in eval_launches]
            row["launches_cli_evaluate"] = {n: eval_launches[n] for n in names
                                            if n in eval_launches}
        return row

    single = [n for n in DINO_CONFIGS if dino[n]["d"] == 176]
    multi = [n for n in DINO_CONFIGS if dino[n]["d"] == 240]
    dino_kernel_rows = [dino_row("train_pe", 176, single), dino_row("train_pe", 240, multi),
                        dino_row("fwd_pe", 176, single), dino_row("fwd_pe", 240, multi)]

    def lora_row(kernel):
        err, k_ms, p_ms, b_ms, b_by, b32_ms, extra = lora_rows[kernel]
        train = kernel == "train_pe"
        row = {"name": f"{kernel}_lora_d{LORA_WIDTH[1]}", "route": "cuda",
               "source": f"nerf_fewshot_tpu_torch/csrc/{kernel}.cu",
               "replaces": ("nerf_fewshot_tpu/render/train_kernel.py:343" if train
                            else "nerf_fewshot_tpu/render/kernels.py:251"),
               "shape": "512x64" if train else "1024x64", "configs": [LORA_TRUNK_CONFIG],
               "launches": lora["launches" if train else "eval_launches"],
               "max_abs_err": max(err, lora["train_err" if train else "fwd_err"]),
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_rate": "3xTF32 at 495 TFLOP/s", "bound_fp32_ms": b32_ms,
               "library_ms": None, **extra}
        if train:
            row["ms_at_the_step_shape"] = {LORA_TRUNK_CONFIG: lora["train_ms"]}
        else:
            row["ms_at_the_eval_chunk_2048x64"] = lora["fwd_ms"]
        return row

    def script_row(name, kernel, replaces, configs, launches):
        err, k_ms, p_ms, b_ms, b_by, b32_ms, extra = script_rows[name]
        return {"name": name, "route": "cuda",
                "source": f"nerf_fewshot_tpu_torch/csrc/{kernel}.cu",
                "replaces": f"nerf_fewshot_tpu/render/{replaces}", "configs": configs,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_rate": "3xTF32 at 495 TFLOP/s",
                "bound_fp32_ms": b32_ms, "library_ms": None, **extra}

    by_width = {d: [n for n in SCRIPT_EPOCHS if script[n]["d"] == d]
                for _, d in SCRIPT_WIDTHS.values()}
    x_launches_script = script[SCRIPT_TRACED]["x_launches"]
    script_kernel_rows = [
        *(script_row(f"train_pe_script_d{d}", "train_pe", "train_kernel.py:343", names,
                     sum(script[n]["launches"] for n in names))
          for d, names in by_width.items()),
        *(script_row(f"fwd_pe_script_d{d}", "fwd_pe", "kernels.py:251", names,
                     sum(script[n]["eval_launches"] for n in names))
          for d, names in by_width.items()),
        script_row(f"render_bwd_d{SCRIPT_X}", "train_pe", "kernels.py:292", [SCRIPT_TRACED],
                   x_launches_script["render_bwd"]),
        script_row(f"fwd_d{SCRIPT_X}", "fwd_pe", "kernels.py:139", [SCRIPT_TRACED],
                   x_launches_script["fwd"]),
        script_row(f"train_d{SCRIPT_X}", "train_pe", "train_kernel.py:320", [SCRIPT_TRACED],
                   x_launches_script["train_x"])]

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fwd_pe",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/fwd_pe.cu",
        "replaces": "nerf_fewshot_tpu/render/kernels.py:251",
        "configs": ["baseline.yaml", "cli evaluate baseline.yaml"],
        "launches": launches + eval_launches["baseline.yaml"],
        "launches_cli_evaluate": {"baseline.yaml": eval_launches["baseline.yaml"]},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_rate": "3xTF32 at 495 TFLOP/s",
        "bound_fp32_ms": bound32_ms,
        "library_ms": None,
    }, train_row("train_pe", 343, train_launches),
        train_row("train_x", 320, x_launches + x_launches_hier), {
        "name": "fwd",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/fwd_pe.cu",
        "replaces": "nerf_fewshot_tpu/render/kernels.py:139",
        "launches": fwd_launches,
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
        "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by,
        "bound_rate": "3xTF32 at 495 TFLOP/s",
        "bound_fp32_ms": fwd_bound32_ms,
        "library_ms": None,
    }, {
        "name": "render_bwd",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/train_pe.cu",
        "replaces": "nerf_fewshot_tpu/render/kernels.py:292",
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "bound_rate": "3xTF32 at 495 TFLOP/s",
        "bound_fp32_ms": bwd_bound32_ms,
        "library_ms": None,
    }, *dino_kernel_rows, lora_row("train_pe"), lora_row("fwd_pe"), *script_kernel_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
