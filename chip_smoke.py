#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``nerf_fewshot_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc. Phases, each printed with
its seconds:

1. device: the card's name, capability and ``nvidia-smi`` power limit;
2. build: nvcc builds every kernel of the paths (``csrc/fwd_pe.cu``: kernels
   2 and 4; ``csrc/train_pe.cu``: kernels 1, 5 and 3; ``csrc/adam.cu``: the
   Adam step the graphed trainer replays; ``csrc/point_features.cu``: the
   kernel path's per-point feature sampler), one process per
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
6a. precision routes, kernels vs plain: all five kernels at
   ``compute_dtype`` ``bfloat16`` (both operands of every product rounded
   to bf16, one tensor-core pass) and ``highest`` (exact fp32 FFMAs), on
   the main path's inputs (D 96) and at the DINO width (pos_freq 12, 64
   features: D 176, a 256-wide x), against their plain versions at the
   same route (TF32 off): two calls bit for bit, ``ROUTE_TOL``, no further
   from a float64 run at the route than ``F64_FACTOR`` times the plain
   version, ``bfloat16`` apart from the ``float32`` route; CUDA-event
   times and the bound at the route's rate; kernels 1 and 3 at D 96 also
   the device time of each grid launch at each route;
6b. the routes vs the parent build: with ``$NERF_PARENT_CHECKOUT`` (a
   checkout of the parent commit), ``tools/route_bits.py`` on both trees:
   all five kernels' outputs at all three routes bit-equal to the parent's
   at trunk widths 256 (the main path's inputs, the DINO width) and 128
   (``REORDERED_VS_PARENT``, empty, would name kernels whose sums a change
   reorders on purpose: those are reported, not gated); then kernels 1, 5
   and 3 timed
   against the parent in alternating pairs (``tools/train_times.py``) at
   every shape and route of ``PERF.md``'s kernel tables; the LoRA pack
   kernels likewise (``tools/lora_pack_times.py``: outputs bit-equal to the
   parent's, device ms); then the main-path trainer over the smoke's
   epochs in alternating pairs
   (``tools/train_runs.py``, one process per run): every run's 670
   per-step losses, final parameters and eval view bit-equal to the
   parent's, the pairs' ms per step (``baseline``, ``dino_nerf``,
   ``lora_trunk``), eval ms per view and traced epochs; without it the
   phase says it was not checked;
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
9a. precision routes, training: ``baseline.yaml`` with
   ``rendering.compute_dtype`` ``bfloat16``, then ``highest``, from the
   same seed, batches and jitter as the train slice: eval at init, epochs
   0, 1 and 100 through kernel 1 (once per step), eval after (PSNR must
   rise), two differentiable render steps and one ``inline_pe=False``
   step at the route; every one of the five kernels launched at the route
   (counts set to 0 before each); epoch 0's per-step losses within rel
   1e-4 of the plain trainer's (``highest``) or ``BF16_LOSS_BAND`` of the
   ``float32`` kernel trainer's (``bfloat16``);
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
   of the epoch, the stream synchronizations and launches per step) and
   with the CPU activity too (device time per step by part: the kernel's
   launches, Adam, the rest; the host's ms per step by part); each traced
   epoch must make at most one stream synchronization (the copy of its
   losses); then an epoch's steps and a ``render_views_device`` call of
   the 8 test views under ``torch.cuda.set_sync_debug_mode("error")``,
   and a traced ``render_views`` call (at most one synchronization). The
   hierarchical, DINO and LoRA-trunk slices and data-parallel world 1 run
   their steps under the same mode, and the DINO and LoRA-trunk traced
   epochs are held to one synchronization. The kernel-path trainers step as
   CUDA graph replays (``training/step_graph.py``): a traced epoch counts a
   graph launch as one launch from the host and prints the step mode and
   each capture's capture and instantiate ms and pool MB. Then the Adam
   kernel (``csrc/adam.cu``) against ``torch.optim.Adam(foreach=True)``
   over 200 steps at weight decay 1e-6 and 0, with the clip on and off, and
   ``AdamW``: parameters, moments and steps bit-equal (``run_adam_gate``);
   its time, the foreach and the fused step's, and its bound;
11a. graph vs eager step: ``baseline``, ``hierarchical``, ``dino_nerf.yaml``
   and the LoRA trunk at each precision route over their slices' epochs, as
   graph replays and through ``Trainer(_eager_step=True)``: losses,
   parameters, moments and steps bit-equal, kernel 1 and the Adam kernel
   once per step (kernel 2 once more, hierarchical; ``run_graph_vs_eager``);
12. hierarchical train slice: ``experiments/hierarchical.yaml`` (a literal
   dict) trains at the same epochs (every step: kernel 2 as the coarse
   pass, kernel 1 over the merged 96 / 112 / 128 samples), PSNR must rise;
   eval runs kernel 2 for both passes; kernel times at the step's shapes;
   one ``fused_train_loss_grad(inline_pe=False)`` step (kernel 4 as the
   coarse pass, kernel 5) against the inline-PE step;
13. repair check: ``experiments/smoke.yaml`` (width 64) trains a phase-0
   epoch on the plain path under ``backend: auto`` and says so in
   ``kernel_path``; under ``fused`` it raises; width 640 (the kernels'
   width-generic build) trains through kernel 1 under ``auto``;
13a. wide trunks: ``baseline.yaml`` with ``nerf_model.hidden_dim`` 512,
   then 384 (built in code; no config ships at these widths, which the JAX
   kernels take), 8 layers: the five kernels on the trainer's init at the
   main path's shapes (kernels 2 and 4 on a 2048x64 eval chunk, 1, 5 and 3
   on the phase-2 batch of 512x64) at ``float32``, ``bfloat16`` and
   ``highest`` against their plain versions (two calls bit for bit, the
   §2 gates, float64 distances, times, bounds and shares); then, counts at
   0, eval at init, epochs 0, 1 and 100 (H 384: 0) through kernel 1 once
   per step, epoch 0 within rel 1e-4 of a ``backend: xla`` trainer, eval
   after (kernel 2 once per chunk; PSNR rising at 512), 5 differentiable
   render steps (kernels 4 and 3) within rel 1e-4 of plain autograd and
   one ``inline_pe=False`` step (kernel 5); then the wider trunks past 512
   (the width-generic build: no activation tile, every layer input
   streamed from its image), the same at ``hidden_dim`` 1024 (epochs 0 and
   100, PSNR rising), 768 and 640 (epoch 0);
13b. past the old caps (the kernels take any samples per ray,
   trunk depth and input width, as the JAX kernels do): the five kernels
   at ``CAP_CASES`` (S 2048 on 64 rays, the compositing state of kernels
   1, 5 and 3 in shared memory past 48 KB; S 8192 on 16 rays, that state
   in the scratch; L 16 and 24 at 512x64, the dW products in launches of
   at most 16; inline D and x 1152 at 512x64; S 2048 and L 16 at H 512;
   the widest case of each cap at all three routes, the rest at
   ``float32``) against their plain versions (two calls bit for bit, the
   §2 gates, float64 distances, times, bounds and shares beside the card's
   ``nvidia-smi`` name and power limit); then, counts at 0 before each,
   ``hierarchical.yaml`` at 32 + 1056 = 1,088 samples per ray (a phase-0
   batch of 256), ``baseline.yaml`` at 16 layers and ``dino_nerf.yaml``
   with ``model.dino_dim`` 1024 (seeded feature maps), built in code:
   epoch 0 through kernel 1 once per step within rel 1e-4 of a ``backend:
   xla`` twin (the hierarchical one: of a twin with kernel 1's plain
   version, the xla twin within 1e-3, its coarse pass rounding cos
   apart), one eval through kernel 2 once per chunk (twice with importance
   sampling), a differentiable render step (kernels 4 and 3) and an
   ``inline_pe=False`` step (kernel 5);
14. DINO kernel widths: kernel 1 at 512x64 and kernel 2 at a 1024x64 eval
   chunk, pos_freq 12, with 64 and 128 features (inputs padded to D 176
   and 240), against their plain versions; times and bounds;
14a. feature sampler kernel: ``csrc/point_features.cu`` against its plain
   version at the shipped configs' shapes (``SAMPLER_CASES``: 64 and 128
   channels on 9x9 maps at 512x64 points, the reference projection; the
   script recipes' 768 channels on 14x14 maps at 4096x64 points, the script
   projection, ``align_corners``; ``invalid_fill: mean``), a stack of 5
   maps and the view index on the device, seeded points in front of and
   behind the camera, on the map's pixel edges and integer coordinates, off
   it, at integer world coordinates: features within 1e-5 of the map's
   largest value, valid equal but at |z| < 1e-6, the mean within rel 1e-6
   (or no further from float64 than the plain mean), a second call
   bit-equal, the share of bit-equal elements printed, the launches
   counted; the mean also on two Gloo ranks on the card (the sums
   all-reduced between the launches) against one process; times, the byte
   bound and share, ``F.grid_sample``'s time for the taps alone (a
   yardstick, never called by the port);
15. DINO slices: ``experiments/dino_nerf.yaml``, ``multiscale.yaml`` and
   ``lora.yaml`` read by the port's own YAML reader at full width (ViT-B/14
   12x768 extractor on the card, 8x256 trunk): feature maps (5, 9, 9, 64)
   or (5, 9, 9, 128); eval at init (kernel 2 with train view 0's features,
   one launch per chunk); epochs 0, 50, 100, 101 (``lora.yaml``: 0), every
   step launching kernel 1 and the sampler kernel once (eval: once per
   chunk; the ``backend: xla`` twin never); epoch 0 against a ``backend: xla`` trainer
   (rel 1e-4); PSNR must rise; the trained views against the plain
   pipeline; both kernels against their plain versions at the trainer's
   shapes; the feature sampler's time, the kernel and the plain sampler;
   one ``dino_nerf`` phase-2 epoch traced;
16. evaluate dino_nerf.yaml, right after the ``dino_nerf.yaml`` slice: the
   same for its trained trainer (features from the extractor on the card,
   1024-ray chunks: 304 launches; the 5x5 feature-consistency matrix; the
   sampler kernel once per chunk and per analysis view, 312);
17. LoRA trunk kernel width: kernel 1 at 512x64 and 1024x64 and kernel 2
   at a 1024x64 eval chunk at the trunk-LoRA config's input (pos_freq 10,
   view directions, 64 features: D 160), against their plain versions;
   times and bounds; then the LoRA pack kernels (``csrc/lora_pack.cu``) at
   ``lora_nerf_trunk.yaml``'s and ``script_lora.yaml``'s shapes, at H 1024
   and at the former's widths at rank 1024 and at 40 layers: the packed
   weights bit-equal to the plain version up to rank 1020 (at rank 1024,
   summed in float64: within rel 1e-6 of it and no further from a float64
   packing), the base, bias and head gradients bit-equal to autograd,
   ``lora_a`` / ``lora_b`` within rel 1e-6 of autograd and no further from
   a float64 run, a second call bit-equal, ceil(L / 32) launches a call;
   device ms of each (20 calls in a CUDA graph), its bound (bytes, or the
   operations at the peak of their type), the plain versions' and
   ``torch.baddbmm``'s (layers 1.. of the merge, TF32 off);
18. LoRA trunk slice: ``experiments/lora_nerf_trunk.yaml`` read by the
   port's reader (8x256 trunk, rank-4 LoRA on every layer, the ViT-B/14
   extractor on the card), trained with ``sigma_bias: 0.1`` (the file as it
   stands starts dead at seed 0, which is reported): epochs 0, 50, 51, 52,
   100 through kernel 1 with the merged weights, the freeze at 51 (base and
   heads bit-equal after it, every ``lora_b`` moved), epoch 0 against a
   ``backend: xla`` twin and the freeze as the first call of a kernel and an
   ``xla`` trainer (rel 1e-4), eval through kernel 2 (PSNR must rise), the
   views against the plain pipeline, both kernels at the trainer's shapes,
   one phase-2 epoch traced; every kernel-path step packs and un-packs the
   trunk with one launch each of the LoRA pack kernels and never calls
   into the autograd engine (counted, and no ``autograd::engine`` range in
   the traced epoch), an eval call packs once;
18a. LoRA trunk past the pack kernels' old caps: ``lora_nerf_trunk.yaml``
   (``sigma_bias: 0.1``) at ``lora_rank: 1024``, then at ``num_layers:
   40``, on the slice's maps, counts at 0 before each: epoch 0 (32x32)
   through kernel 1 once a step and each LoRA pack kernel ceil(L / 32)
   times a step, no call into the autograd engine, per-step losses within
   rel 1e-4 of a ``backend: xla`` twin; test view 0 through kernel 2 (once
   per chunk, one packing) within the view tolerances of the twin's;
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
   steps each through kernel 1 and the sampler kernel (launches = steps;
   eval once per chunk, the twin never), epoch 0 against a
   ``backend: xla`` twin (rel 1e-4), eval through kernel 2 (one launch per
   chunk), PSNR rising, the trained views against the plain pipeline, both
   kernels and the 768-channel feature sampler at the trainer's shapes;
   one 64x64 epoch of ``script_projection`` traced, then a differentiable
   render step (kernels 4 and 3) and an ``inline_pe=False`` step (kernel
   5) on its 896-wide x; ``script_baseline.yaml`` (no sigma bias) through
   ``fit`` for 6 epochs, its ``dead_sigma_epochs`` reported, not gated;
23. pretrained-format DINOv2: a complete ``facebook/dinov2-base`` state
   dict in HF's key layout (all 12 layers, 1370-row position table),
   drawn from the seed at init-like scales, saved as ``pytorch_model.bin``
   in an HF hub snapshot under a temporary ``$HF_HOME``; the
   ``dino_nerf.yaml`` extractor must print its load line, its maps must
   differ from the random-init maps (> 1e-4) and equal the same
   extractor's maps on the CPU (1e-4); the weight file's read time; then
   the DINO slice's training and eval gates on those maps at epochs 0, 1,
   50, 100 (kernel 1 every step, kernel 2 every eval chunk, epoch 0
   against a ``backend: xla`` trainer, PSNR rising);
24. dino_lora dumper: ``cli extract-features`` in this process on a
   ``dino_lora`` config (5 views at 128x128, ``--synthetic``) with the same
   weight file: tokens (5, 256, 768), finite, equal to the CPU port's dump
   (1e-4), unlike the random-init dump; the extractor's ms per view;
25. kernel gradient gate: ``render/verify.py``'s ``kernel_gradient_check``
   at sigma_bias 0.1 and 5.0 must both be ``ok`` (kernel 1 against plain
   autograd), with their errors printed;
26. sigma noise: ``baseline.yaml`` with ``strict_reference_behavior:
   false`` and ``rendering.noise_std: 1.0`` trains epochs 0 and 1 on the
   plain path with the JAX trainer's reason, launches no kernel, keeps its
   losses finite; ``backend: fused`` raises;
27. CLI: ``python -m nerf_fewshot_tpu_torch.cli train --config
   experiments/dino_nerf.yaml --synthetic --epochs 2`` as a subprocess
   must exit 0, write ``final.ckpt`` and print the summary JSON with the
   kernel path;
28. data parallel: ``baseline.yaml`` at its published widths on the
   synthetic scene at 128x128 under ``Trainer(mesh=...)``, epochs 0, 1 and
   50. World 1 on a one-rank NCCL group in this process: per-step losses
   and parameters bit-equal to a no-mesh trainer's from the same seed
   (a one-rank all-reduce is a copy), kernel 1 once per step, then its eval
   with kernel 2 once per chunk. World 2: two spawned ranks on the one card
   over Gloo: both ranks' losses and parameters bit-equal, epoch 0's
   per-step losses within rel 1e-4 of world 1's, kernel 1 once per step per
   rank on half the batch's rays. Printed, not gated: ms per step (no
   mesh, world 1, world 2) and the two all-reduces' share of a step.
   ``dino_nerf.yaml`` on seeded maps at epoch 0 the same way (world 1 bit-
   equal to no mesh, world 2 within rel 1e-4), each rank sampling its
   shard through the sampler kernel once per step; ``lora_nerf_trunk.yaml``
   on seeded maps at world 1, graphed and eager, bit-equal to no mesh, each
   step (and replay) launching both LoRA pack kernels once.
   Then ``multihost_train_smoke --kernels`` as two Gloo processes on the
   card (equal losses) and ``cli train --config experiments/dino_nerf.yaml
   --synthetic --epochs 2 --multihost`` at world 1 (NCCL, the group read
   from ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) as
   subprocesses: exit 0, the ``[mesh]`` line, the kernel path.

Any failure raises and exits non-zero. On success the last three lines are
the ``nvidia-smi`` name/power-limit line, a JSON line with the kernels'
numbers (the five kernels, kernels 1 and 2 at the DINO widths with the
pretrained-format run's launches, then at the trunk-LoRA width, then the
LoRA pack kernels (``lora_pack``, ``lora_pack_vjp``: the LoRA trunk
slice's, the rank-1024 and 40-layer trainers', ``script_lora.yaml``'s,
``script_projection.yaml``'s (rank 16) and the LoRA data-parallel run's
launches),
then the five at the script recipes' widths, then each kernel at ``bfloat16`` and
at ``highest`` (``<name>_bf16``, ``<name>_highest``: main-path times, the
route's bound, launches from the route trainings), then the five at trunk
widths 384, 512, 640, 768 and 1024 (``<name>_h384`` .. ``<name>_h1024``:
the wide phase's launches and ``float32`` numbers, the other routes under
``routes``, the build under ``build``), then
the five past the old caps (``<name>_<case>`` of ``CAP_CASES``: the caps
phase's launches by the trainer of that cap); kernel 1's row counts the gradient
gate's two launches and the data-parallel phase's, kernel 2's the
world-1 eval's), and
``{"ok": true, "device": {...}}``.
"""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, redirect_stdout

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
FP64_FLOPS = 34e12  # NVIDIA's H100 SXM data sheet: float64 outside the tensor cores
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
KERNELS = ("fwd_pe", "train_pe", "adam", "point_features", "lora_pack")  # one nvcc each
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
# The LoRA pack kernels' shapes: (pos_freq, dir_freq, view directions,
# features, H, layers, rank) of lora_nerf_trunk.yaml, script_lora.yaml, a
# 1024-wide trunk at the former's input, and the former at rank 1024 (the
# merge's float64 sums) and at 40 layers (two launches of each kernel); the
# first is the kernels' row.
LORA_PACK_CASES = {"lora_nerf_trunk.yaml": (10, 4, True, 64, 256, 8, 4),
                   "script_lora.yaml": (10, 4, False, 768, 256, 8, 4),
                   "H 1024": (10, 4, True, 64, 1024, 8, 4),
                   "rank 1024": (10, 4, True, 64, 256, 8, 1024),
                   "40 layers": (10, 4, True, 64, 256, 40, 4)}
LORA_PACK_VJP_RTOL = 1e-6  # lora_a / lora_b: sums in float64, autograd's in fp32
# above lora_pack.TORCH_ORDER_RANK the packing's float64 sums against the
# plain packing's fp32 ones
LORA_PACK_FWD_RTOL = 1e-6
# lora_nerf_trunk.yaml past the LoRA pack kernels' old caps, one override
# each (nerf_model), trained one epoch (0, 32x32) through the kernels
LORA_CAP_CONFIGS = {"lora_rank 1024": {"lora_rank": 1024}, "num_layers 40": {"num_layers": 40}}
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
# The pretrained-format DINOv2 phase: dino_nerf.yaml on the maps of a
# seeded ViT-B/14 state dict in HF's layout, saved as an HF hub snapshot
# under a temporary $HF_HOME, trained at these epochs (phase 0 twice, then
# the 64x64 and 128x128 phases). The dino_lora dumper writes DUMP_VIEWS
# views' tokens (V, 256, 768) at 128x128 with the same weight file.
# Card vs CPU for the maps and the dumped tokens: the fp32 ViT's sums in
# other orders (TF32 cleared), ~1e-6 on LayerNorm-scale values.
PRETRAINED_LABEL = "dino_nerf.yaml pretrained-format"
PRETRAINED_EPOCHS = (0, 1, 50, 100)
DUMP_VIEWS = 5
CARD_CPU_ATOL = 1e-4
LOAD_LINE = "[dino] loaded pretrained backbone weights from "
NOISE_REASON = "sigma noise_std != 0 is not implemented in the kernels"
NOISE_EPOCHS = (0, 1)
# Data parallelism: the baseline at its published widths under a mesh.
# Epochs 0 and 1 (five 1024 x 32 steps each) gate the ranks, epochs 50 (twenty
# 1024 x 48 steps, the phase's capture) and 51 (replays only) are timed.
# World 1 runs on NCCL in this process (graphed, and eager beside it), world
# 2 as two spawned ranks on the one card over Gloo (NCCL refuses two ranks on
# one device; Gloo steps eagerly). World 2 against world 1: the order of the
# sums differs, so per-step losses of epoch 0 within rel DP_LOSS_RTOL.
DP_EPOCHS = (0, 1, 50, 51)
DP_DINO_EPOCHS = (0,)  # dino_nerf.yaml under a mesh: each rank samples its shard
DP_LOSS_RTOL = 1e-4
# The precision routes (render/kernels.py ROUTES) of all five kernels, and
# the rates their bounds count at: bfloat16 one bf16 tensor-core product per
# product, highest fp32 FFMAs on the CUDA cores.
ROUTES = ("bfloat16", "highest")
ROUTE_RATE = {"bfloat16": (989e12, "bf16 at 989 TFLOP/s"),
              "highest": (FP32_FLOPS, "fp32 CUDA cores at 67 TFLOP/s")}
ROUTE_SHORT = {"bfloat16": "bf16", "highest": "highest"}
# Kernel vs plain at a route. highest: the float32 gates. bfloat16: a bf16
# rounding that the kernel's and cuBLAS's fp32 sum orders put on two sides
# of a tie moves an element by 2^-8 of itself, and the backward's suffix
# sums amplify it (a first card run, NVIDIA H100 80GB HBM3 at 700 W:
# outputs within 7.4e-5, the objective's loss and gradients rel 1.6e-5,
# the render VJP rel 5.1e-4 with standard-normal cotangents).
ROUTE_TOL = {"highest": {**TOL, "grad": TRAIN_GRAD_TOL},
             "bfloat16": {"rgb": 1e-3, "depth": 1e-2, "acc": 1e-3, "weights": 1e-3,
                          "grad": 5e-3}}
# The kernel is no further from a float64 run of the plain version at the
# same route than the fp32 plain version is, by at most this factor.
F64_FACTOR = 2.0
# bfloat16 apart from float32 (a route that ignored the dtype): render
# outputs by at least ROUTE_APART_OUT, gradients by rel ROUTE_APART_GRAD.
ROUTE_APART_OUT, ROUTE_APART_GRAD = 1e-5, 1e-4
# The route trainings: baseline.yaml at each route, epochs 0 and 1 (32x32)
# and one 128x128 epoch of phase 2; epoch 0's per-step losses against the
# float32 slice's: highest within rel TRAIN_LOSS_RTOL of the plain
# (backend: xla) trainer, bfloat16 within rel BF16_LOSS_BAND of the float32
# kernel trainer (read 3.4e-5 on an NVIDIA H100 80GB
# HBM3 at 700 W: bf16 products move the init's forward losses by ~1e-5).
ROUTE_EPOCHS = (0, 1, 100)
BF16_LOSS_BAND = 1e-3
ROUTE_RENDER_STEPS = 2
# The wide trunks: baseline.yaml at trunk widths 384 and 512 (no shipped
# config; the JAX kernels take them), trained through the kernels at these
# epochs (H 512: both 32x32 epochs and one 512x64 phase-2 epoch; H 384: one
# epoch), with WIDE_RENDER_STEPS differentiable render steps each; then the
# wider trunks past 512 (the kernels' width-generic build) the same way (H
# 1024: epochs 0 and 1; H 768 and 640: epoch 0). WIDE_PSNR_RISE: the epoch
# after which PSNR must be above its value at init (an eval there). The
# recipe's lr of 5e-4 kills a 1024-wide trunk in its first epoch at seed 0
# (relu(sigma) zero everywhere, the dead basin; PERF.md §6), on the
# plain path as on the kernels: H 1024 trains at the lr scaled with the
# width from 256 (WIDE_LR), and first takes epoch 0 at the published lr on
# both paths, held together. WIDE_TWIN_EPOCHS: the epochs held against the
# xla twin (the others: the first).
WIDE_WIDTHS = (512, 384)
WIDER_WIDTHS = (1024, 768, 640)
WIDE_EPOCHS = {512: (0, 1, 100), 384: (0,), 1024: (0, 1), 768: (0,), 640: (0,)}
WIDE_PSNR_RISE = {512: 100, 1024: 1}
WIDE_TWIN_EPOCHS = {1024: (0, 1)}
WIDE_LR = {1024: BASELINE_CONFIG["optimizer"]["lr"] * 256 / 1024}
WIDE_RENDER_STEPS = 5
MAX_FIXED_WIDTH = 512  # the widest trunk with a build of its own (csrc kMaxFixedH)


# The caps the kernels once had and the JAX kernels never had:
# samples per ray past 1024 (the objective's and the VJP's compositing state
# in shared memory past 48 KB at S 2048, in the scratch at S 8192), trunks
# deeper than 15 layers (the dW products in launches of at most 16) and
# inputs wider than 896 columns (inline D 1152 and an x 1152 wide: 90 PE
# columns + 1062 features). Per case: (R, S, H, L, features) and the routes
# it runs at, the widest case of each cap at all three.
ALL_ROUTES = ("float32", "bfloat16", "highest")
CAP_CASES = {
    "s2048": ((64, 2048, 256, 8, 0), ("float32",)),
    "s8192": ((16, 8192, 256, 8, 0), ALL_ROUTES),
    "l16": ((512, 64, 256, 16, 0), ("float32",)),
    "l24": ((512, 64, 256, 24, 0), ALL_ROUTES),
    "d1152": ((512, 64, 256, 8, 1062), ALL_ROUTES),
    "s2048_h512": ((64, 2048, 512, 8, 0), ("float32",)),
    "l16_h512": ((512, 64, 512, 16, 0), ("float32",)),
}
CAP_KERNELS = ("fwd_pe", "fwd", "render_bwd", "train_pe", "train_x")
# The caps phase's trainers (configs built in code, as wide_config; no
# experiment file ships past a cap): hierarchical.yaml with 32 + 1056 =
# 1,088 samples per ray at a phase-0 batch of 256 (training.batch_size 128:
# the schedule doubles it before epoch 50), baseline.yaml at 16 layers, and
# dino_nerf.yaml with model.dino_dim 1024 (an MLP input of 1,126 columns,
# D 1136 inline, x 1152) on feature maps drawn from the seed. Which cap
# cases' rows in the kernels line take each trainer's launches.
CAP_TRAINERS = ("samples", "layers", "width")
CAP_CONFIG_NAMES = {"samples": "hierarchical.yaml n_importance 1056 (1,088 samples)",
                    "layers": "baseline.yaml num_layers 16",
                    "width": "dino_nerf.yaml dino_dim 1024"}
CAP_ROWS = {"samples": ("s2048", "s8192", "s2048_h512"), "layers": ("l16", "l24", "l16_h512"),
            "width": ("d1152",)}


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


def hf_dinov2_state_dict(rng, hidden=768, layers=12, mlp=3072, patch=14, side=37):
    """A complete HuggingFace ``Dinov2Model`` state dict (``facebook/dinov2-base``'s
    key names and shapes at the default widths) at init-like scales from
    ``rng``: ``cls_token`` (1, 1, E), ``mask_token``, ``position_embeddings``
    (1, 1 + side^2, E), the patch conv (E, 3, p, p), per layer the q/k/v,
    output, fc1 and fc2 linears (weights N(0, 0.02^2), biases N(0, 0.01^2)),
    layer scales near 0.1 and LayerNorms near 1; the final ``layernorm``."""
    def t(shape, scale, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    sd = {"embeddings.cls_token": t((1, 1, hidden), 0.02),
          "embeddings.mask_token": t((1, hidden), 0.02),
          "embeddings.position_embeddings": t((1, 1 + side * side, hidden), 0.02),
          "embeddings.patch_embeddings.projection.weight": t((hidden, 3, patch, patch), 0.02),
          "embeddings.patch_embeddings.projection.bias": t((hidden,), 0.01)}
    linears = {"attention.attention.query": (hidden, hidden),
               "attention.attention.key": (hidden, hidden),
               "attention.attention.value": (hidden, hidden),
               "attention.output.dense": (hidden, hidden),
               "mlp.fc1": (mlp, hidden), "mlp.fc2": (hidden, mlp)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, shape in linears.items():
            sd[p + name + ".weight"] = t(shape, 0.02)
            sd[p + name + ".bias"] = t(shape[:1], 0.01)
        for name in ("norm1", "norm2"):
            sd[p + name + ".weight"] = t((hidden,), 0.1, 1.0)
            sd[p + name + ".bias"] = t((hidden,), 0.01)
        sd[p + "layer_scale1.lambda1"] = t((hidden,), 0.02, 0.1)
        sd[p + "layer_scale2.lambda1"] = t((hidden,), 0.02, 0.1)
    sd["layernorm.weight"] = t((hidden,), 0.1, 1.0)
    sd["layernorm.bias"] = t((hidden,), 0.01)
    return sd


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


def compare_train_or_f64(name, a, o, tt):
    """``compare_train`` of kernel 1 or 5 on ``(a, o)`` against its plain
    version at TRAIN_GRAD_TOL or, where the gradients are further apart,
    the §2 rules of the card tests: the kernel no further from a float64
    run of the plain version than F64_FACTOR times the fp32 plain version
    is (a ReLU gate near zero can round to two sides in two fp32 sum
    orders); or, where a transmittance reaches the 1e-10 floor,
    TRAIN_GRAD_TOL_SATURATED (the float32 route's T = exp(incl - log om),
    as the JAX body computes it, loses digits there). Returns the max abs
    error."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.tools.f64_cases import objective_f64

    got, want = tt.fused_train_objective(*a, **o), tt.fused_train_objective_reference(*a, **o)
    try:
        return compare_train(name, got, want, TRAIN_GRAD_TOL)
    except RuntimeError:
        flat = lambda r: torch.cat([t.reshape(-1).double() for t in r[1]])
        exact = flat(objective_f64(a, o))
        k64, p64 = (((flat(r) - exact).norm() / exact.norm()).item() for r in (got, want))
        x = tk._pe_input(a[0], a[1], a[7], a[8], a[9][0].shape[0]) if o["inline_pe"] else a[0]
        z = a[2]
        sigma = tk._trunk(x, a[9])[0][:, 3].reshape(z.shape)
        floor = int((tk._composite_terms(sigma, z, a[3])[1] < 2e-10).sum())
        counts = dict(tt.fused_train_objective.launches)  # a reading, not the path's launch
        h64 = ((flat(tt.fused_train_objective(*a, **{**o, "compute_dtype": "highest"}))
                - exact).norm() / exact.norm()).item()
        tt.fused_train_objective.launches = counts
        print(f"  {name}: against a float64 run kernel rel {k64:.2e}, plain rel {p64:.2e} "
              f"(factor {F64_FACTOR}), the kernel at highest rel {h64:.2e}; {floor} samples "
              f"at the 1e-10 floor", flush=True)
        if abs(got[0].item() / want[0].item() - 1.0) > 1e-5 or not (k64 <= F64_FACTOR * p64
                                                                    or floor):
            raise
        if k64 <= F64_FACTOR * p64:
            return max((x - y).abs().max().item() for x, y in zip(got[1], want[1]))
        return compare_train(name, got, want, TRAIN_GRAD_TOL_SATURATED)


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
                 "render_dx", "train_finalize", "loss_sum", "weight_image", "fwd_split",
                 "fwd_trunk", "fwd_composite", "adam_step", "point_features", "lora_pack_fwd",
                 "lora_pack_vjp")


# The CUDA API calls that launch a kernel (`cudaLaunch*` of the runtime,
# through which the port's libraries and PyTorch's ops launch, and the
# lower-level `cuLaunch*`).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


def trace(run, with_cpu):
    """``run()`` (which returns its number of steps) under ``torch.profiler``.
    With the CUDA activity only (``with_cpu`` False) the host is slowed
    least: the device's busy time is the union of its kernel and copy
    intervals, set against the run's wall time, and the stream
    synchronizations and kernel launches the host made are counted. With
    the CPU activity too, Adam's device time is read from the optimizer's
    own ``Optimizer.step#...`` range, and the host's time per step is split
    by the top-level ranges of the stepping thread and the autograd
    thread: ``adam`` (the optimizer's range), ``backward`` (the autograd
    engine's), ``ops`` (every other top-level PyTorch op: gathers,
    sampling, encoding, packing, the kernels' output allocations) and
    ``python`` (the rest of the wall: the trainer's and the glue's Python,
    the ctypes calls into the kernels), and by top-level range. Device-side
    spans of annotated ranges are not kernels and are left out. Returns the wall ms, the busy
    ms, the synchronizations of the whole run, and per step: device ms by
    part (the CUDA kernels' launches by name, ``adam`` with the CPU
    activity, ``other``: gather, sampling, encoding, ``pack_params`` and its
    backward, copies), device events (also by kernel name), stream
    synchronizations, launches and (with the CPU activity) host ms by part
    and by top-level range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts, spans, adam, syncs, launches = {}, [], 0.0, 0, 0
    host = {"adam": 0.0, "backward": 0.0, "ops": 0.0}
    host_ops, kernels = {}, {}
    for evt in prof.events():
        if evt.name == "cudaStreamSynchronize":
            syncs += 1
        if evt.name in LAUNCH_CALLS:
            launches += 1
        if evt.device_type == DeviceType.CPU and evt.cpu_parent is None and with_cpu \
                and not evt.name.startswith("cu"):
            key = ("adam" if evt.name.startswith("Optimizer.step#") else
                   "backward" if evt.name.startswith("autograd::engine") else "ops")
            host[key] += evt.cpu_time_total / 1e3
            host_ops[evt.name] = host_ops.get(evt.name, 0.0) + evt.cpu_time_total / 1e3
        if evt.name.startswith("Optimizer.step#"):
            if evt.device_type == DeviceType.CPU:
                adam += evt.device_time_total / 1e3
            continue
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        kernels[evt.name[:60]] = kernels.get(evt.name[:60], 0) + 1
        group = next((g for g in KERNEL_GROUPS if g in evt.name), "other")
        parts[group] = parts.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    if with_cpu:
        parts["other"] = parts.get("other", 0.0) - adam
        parts["adam"] = adam
        # the autograd thread's ranges overlap the stepping thread's wait in
        # backward(): the stepping thread's wall less its ranges is Python
        host["python"] = max(wall_ms - host["adam"] - host["ops"] - host["backward"], 0.0)
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3,
                parts={k: v / steps for k, v in parts.items()},
                events=len(spans) / steps, syncs=syncs / steps, syncs_total=syncs,
                launches=launches / steps, steps=steps,
                host={k: v / steps for k, v in host.items()} if with_cpu else None,
                host_ops={k: v / steps for k, v in host_ops.items()},
                kernels={k: v / steps for k, v in kernels.items()})


def trace_epoch(trainer, epoch, with_cpu):
    """One ``train_epoch`` under ``trace``, with the trainer's step mode and
    its graph captures so far (``captures``: phase, capture and instantiate
    ms, the private pool's MB)."""
    trainer.phase_data(trainer._phase_index(epoch))

    def run():
        trainer.train_epoch(epoch)
        return len(trainer.last_step_losses)

    t = trace(run, with_cpu)
    # (a parent checkout's trainer, traced by tools/train_runs.py, has neither)
    t["step_mode"] = (getattr(trainer, "step_mode", None) or "eager",
                      getattr(trainer, "step_mode_reason", None))
    t["captures"] = [{k: c[k] for k in ("phase", "capture_ms", "instantiate_ms", "pool_mb")}
                     for c in getattr(trainer, "graph_captures", [])]
    return t


def print_launch_times(label, fn, calls=10):
    """Device ms per call of each grid launch that ``fn()`` makes (``trace``
    over ``calls`` calls, the CUDA activity only)."""
    fn()
    t = trace(lambda: len([fn() for _ in range(calls)]), with_cpu=False)
    print(f"  {label}, device ms per call by grid launch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(t["parts"].items(), key=lambda kv: -kv[1]))
        + f", sum {sum(t['parts'].values()):.3f}", flush=True)


def print_trace(label, t, untraced_ms, max_syncs=None):
    """Print a traced run; with ``max_syncs``, raise if the run made more
    stream synchronizations than that."""
    if not t["busy_ms"] > 0:
        raise RuntimeError("the profiler recorded no device time")
    host = "" if t["host"] is None else ", host ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(t["host"].items(), key=lambda kv: -kv[1])) + \
        f", sum {sum(t['host'].values()):.3f}"
    print(f"  {label}: wall {t['wall_ms']:.1f} ms ({t['wall_ms'] / untraced_ms:.3f}x untraced), "
          f"device busy {t['busy_ms']:.1f} ms ({t['busy_ms'] / t['wall_ms']:.1%} of the traced "
          f"wall), {t['syncs_total']} stream synchronizations in {t['steps']} steps; per step: "
          f"{t['events']:.1f} device events, {t['syncs']:.3f} stream synchronizations, "
          f"{t['launches']:.1f} launches, device ms " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(t["parts"].items(), key=lambda kv: -kv[1]))
          + f", sum {sum(t['parts'].values()):.3f}{host}", flush=True)
    if "step_mode" in t:
        mode, reason = t["step_mode"]
        print(f"    steps as {mode}" + (f" ({reason})" if reason else " replays") + "; captures: "
              + ", ".join(f"phase {c['phase']} capture {c['capture_ms']:.1f} ms, instantiate "
                          f"{c['instantiate_ms']:.1f} ms, pool {c['pool_mb']:.1f} MB"
                          for c in t["captures"]), flush=True)
    if t["host"] is not None:
        top = sorted(t["host_ops"].items(), key=lambda kv: -kv[1])[:12]
        print("    host ms per step by top-level range: " + ", ".join(
            f"{k} {v:.3f}" for k, v in top), flush=True)
        top = sorted(t["kernels"].items(), key=lambda kv: -kv[1])[:16]
        print("    device events per step by name: " + ", ".join(
            f"{k} {v:.2f}" for k, v in top), flush=True)
    if max_syncs is not None and t["syncs_total"] > max_syncs:
        raise RuntimeError(f"{label}: {t['syncs_total']} stream synchronizations, more than "
                           f"{max_syncs}")


def adam_layouts_report(trainer, steps=5):
    """Reported, not gated: Adam (the trainer's optimizer config) on copies
    of a trainer's parameters (a trunk without LoRA or features, as the
    baseline's), stepped with its step's gradients as they
    come (views of the packed gradients: the weights' transposed) and with
    contiguous copies of them; whether the parameters stay bit-equal, and
    the launches per step of each (foreach's per-tensor fallback takes the
    mixed layouts)."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.training.optim import make_optimizer

    cfg = trainer.cfg
    a, o = main_path_train_args(trainer, len(cfg.phases) - 1, trainer.device)
    params = dict(trainer.model.named_parameters())
    with torch.no_grad():
        _, dpacked = tt.fused_train_objective(*a, **o)
    consts = tk.pe_constants(cfg.nerf.pos_freq, cfg.nerf.dir_freq, cfg.nerf.use_viewdirs, 0,
                             trainer.device)
    grads = tk.packed_grads(params, cfg.nerf.num_layers, cfg.nerf.hidden_dim, a[-1][0].shape[0],
                            consts.row_perm, dpacked)
    out = {}
    for label, layout in (("as they come", lambda g: g), ("contiguous", torch.Tensor.contiguous)):
        copies = [(k, torch.nn.Parameter(v.detach().clone())) for k, v in params.items()]
        opt = make_optimizer(cfg.optimizer, copies)

        def run():
            for _ in range(steps):
                for k, p in copies:
                    p.grad = layout(grads[k])
                opt.step()
            return steps

        t = trace(run, with_cpu=False)
        out[label] = ([p.detach().clone() for _, p in copies], t["launches"])
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(out["as they come"][0], out["contiguous"][0]))
    print(f"  Adam over {steps} steps on the step's gradients as they come: "
          f"{out['as they come'][1]:.1f} launches per step; on contiguous copies: "
          f"{out['contiguous'][1]:.1f} (copies included); parameters bit-equal: {same} "
          f"(reported)", flush=True)


# (kind, weight decay, global-norm clip) of the Adam kernel's gate
ADAM_GATE_CASES = (("adam", 1e-6, 0.0), ("adam", 0.0, 0.0), ("adam", 1e-6, 1.0),
                   ("adam", 0.0, 1.0), ("adamw", 1e-6, 0.0))
ADAM_GATE_STEPS = 200
ADAM_BYTES_PER_PARAM = 28  # reads p, g, m, v and writes p, m, v, fp32


def adam_steps(device, kind, wd, clip, kernel, steps=ADAM_GATE_STEPS, epochs=4, seed=0):
    """``steps`` optimizer steps of the baseline's 8x256 ``NeRFMLP`` from its
    seed, in ``epochs`` epochs whose lr halves at each (milestones), on
    gradients drawn from a seeded generator at scales over three decades
    (a clip at 1.0 then acts on some steps and not on others): through the
    Adam kernel (``AdamKernel``) or through torch's foreach step. Returns the
    optimizer."""
    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
    from nerf_fewshot_tpu_torch.training import optim as toptim
    from nerf_fewshot_tpu_torch.training.config import OptimizerConfig

    model = NeRFMLP(use_viewdirs=True, sigma_bias_init=0.1,
                    generator=torch.Generator().manual_seed(seed)).to(device)
    params = list(model.parameters())
    opt = toptim.make_optimizer(OptimizerConfig(lr=5e-4, weight_decay=wd, kind=kind,
                                                grad_clip=clip), params, clip_hook=False)
    grads = [torch.zeros_like(p) for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    per = steps // epochs
    adam = toptim.AdamKernel(opt, grads, per) if kernel else None
    gen = torch.Generator(device).manual_seed(seed + 1)
    scales = np.random.default_rng(seed).uniform(-4.0, -1.0, steps)
    for e in range(epochs):
        toptim.set_learning_rate(opt, 5e-4 * 0.5 ** e)
        if adam is not None:
            adam.begin_epoch(per)
        for i in range(per):
            for g in grads:
                g.copy_(torch.randn(g.shape, generator=gen, device=device)
                        * float(10.0 ** scales[e * per + i]))
            if clip:
                toptim.clip_by_global_norm_(params, clip)
            (opt.step if adam is None else adam.step)()
        if adam is not None:
            adam.end_epoch(per)
    return opt


def run_adam_gate(device, iters=200):
    """The Adam kernel (``csrc/adam.cu``) against ``torch.optim.Adam(foreach=
    True)`` (``AdamW`` for ``adamw``) over ``ADAM_GATE_STEPS`` steps at each of
    ``ADAM_GATE_CASES`` (``adam_steps``): parameters, both moments and the
    step count bit-equal, or raise. Then at the baseline's parameters (the
    main path's 0.59 M) the CUDA-event ms per step of the kernel, of the
    foreach step (its plain version) and of ``Adam(fused=True)`` (one
    library call), beside the bound: the bytes at the HBM rate. Returns the
    numbers of the kernels line's row."""
    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.optim import AdamKernel, make_optimizer

    worst = 0.0
    for kind, wd, clip in ADAM_GATE_CASES:
        got = adam_steps(device, kind, wd, clip, kernel=True)
        want = adam_steps(device, kind, wd, clip, kernel=False)
        bad = []
        for i, (p, q) in enumerate(zip(got.param_groups[0]["params"],
                                       want.param_groups[0]["params"])):
            worst = max(worst, float((p.detach() - q.detach()).abs().max()))
            pairs = [(p.detach(), q.detach())] + [(got.state[p][k], want.state[q][k])
                                                  for k in ("exp_avg", "exp_avg_sq")]
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in pairs) \
                    or float(got.state[p]["step"]) != float(want.state[q]["step"]):
                bad.append(i)
        print(f"  Adam kernel vs torch {kind} foreach, weight decay {wd}, clip {clip or 'off'}: "
              f"{ADAM_GATE_STEPS} steps, parameters, moments and steps "
              f"{'bit-equal' if not bad else f'differ in tensors {bad}'}", flush=True)
        if bad:
            raise RuntimeError(f"the Adam kernel is not bit-equal to torch's {kind} step")
    cfg = config_from_dict(BASELINE_CONFIG).optimizer
    model = NeRFMLP(use_viewdirs=True, sigma_bias_init=0.1,
                    generator=torch.Generator().manual_seed(0)).to(device)
    n = sum(p.numel() for p in model.parameters())

    def copies():
        ps = [torch.nn.Parameter(p.detach().clone()) for p in model.parameters()]
        for p in ps:
            p.grad = torch.randn(p.shape, generator=torch.Generator(device).manual_seed(3),
                                 device=device) * 1e-3
        return ps

    kps = copies()
    adam = AdamKernel(make_optimizer(cfg, kps, clip_hook=False), [p.grad for p in kps],
                      3 * iters + 3)
    adam.begin_epoch(3 * iters + 3)
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    steps = {"kernel": adam.step, "foreach": torch.optim.Adam(copies(), foreach=True, **kw).step,
             "fused": torch.optim.Adam(copies(), fused=True, **kw).step}
    # device ms a step (the profiler's kernel time: one launch of the kernel
    # is shorter than its host's launch), and the CUDA-event wall of a loop
    dev, wall = {}, {}
    for name, step in steps.items():
        wall[name] = cuda_ms(step, iters)
        t = trace(lambda: len([step() for _ in range(iters)]), with_cpu=False)
        dev[name] = sum(t["parts"].values())
    bound_ms = n * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
    print(f"  Adam at the baseline's {n} parameters, device ms a step: kernel "
          f"{dev['kernel']:.4f}, foreach {dev['foreach']:.4f}, fused {dev['fused']:.4f}; "
          f"CUDA-event wall of {iters} in a loop: {wall['kernel']:.4f}, {wall['foreach']:.4f}, "
          f"{wall['fused']:.4f}; bound {bound_ms:.4f} ms by bytes "
          f"({n * ADAM_BYTES_PER_PARAM / 1e6:.2f} MB; share {bound_ms / dev['kernel']:.1%})",
          flush=True)
    return {"max_abs_err": worst, "ms": dev["kernel"], "plain_ms": dev["foreach"],
            "library_ms": dev["fused"], "bound_ms": bound_ms, "bound_by": "bytes", "params": n,
            "wall_ms": wall}


# the graph gate's configs: the smoke's single-card kernel-path trainers at
# their slices' epochs
GRAPH_GATE_EPOCHS = {"baseline": TRAIN_EPOCHS, "hierarchical": TRAIN_EPOCHS,
                     "dino_nerf": DINO_EPOCHS, "lora_trunk": LORA_EPOCHS}


def run_graph_vs_eager(train, test, device):
    """Every single-card kernel-path config the smoke trains (``baseline``,
    ``hierarchical``, ``dino_nerf.yaml`` and the LoRA trunk on the card's
    ViT-B/14 maps) at each precision route, over its slice's epochs, as
    CUDA graph replays and through the card's eager step
    (``Trainer(_eager_step=True)``): every epoch's per-step losses, the
    final parameters, both Adam moments and the step counts bit-equal, the
    graph's launches per step (kernel 1 and the Adam kernel once, kernel 2
    once more with hierarchical sampling, the feature sampler's kernel once
    with features, the LoRA pack kernels once each with a LoRA trunk), no
    call into the autograd engine in either, or raise; each capture's cost printed, and the ms per
    step of both over the epochs in which the graph only replayed apart from
    those in which it captured (the warm-up steps, the capture, the
    instantiation and first uses). Returns the graph trainers' ms per
    replayed step at ``float32``, by config."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config
    from nerf_fewshot_tpu_torch.training.step_graph import kernel_launch_counts
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    dcfg = load_config(os.path.join(ROOT, "experiments", "dino_nerf.yaml"))
    _, lcfg = lora_trunk_configs()
    bases = {"baseline": (BASELINE_CONFIG, None), "hierarchical": (HIERARCHICAL_CONFIG, None),
             "dino_nerf": (dcfg.raw, _precompute_features(dcfg, train, device)),
             "lora_trunk": (lcfg.raw, _precompute_features(lcfg, train, device))}
    out = {}
    for name, (raw, feats) in bases.items():
        for route in ALL_ROUTES:
            cfg = config_from_dict({**raw, "rendering": {**raw["rendering"],
                                                         "compute_dtype": route}})
            g = Trainer(cfg, train, test, device=device, dino_features=feats)
            e = Trainer(cfg, train, test, device=device, dino_features=feats, _eager_step=True)
            for i in range(len(cfg.phases)):
                g.phase_data(i)
                e.phase_data(i)
            # (mode, whether the graph captured in the epoch) -> [seconds, steps]
            sec = {(m, c): [0.0, 0] for m in ("graph", "eager") for c in (False, True)}
            for epoch in GRAPH_GATE_EPOCHS[name]:
                before = kernel_launch_counts()
                captures = len(g.graph_captures)
                torch.cuda.synchronize()
                with autograd_calls() as calls:
                    t0 = time.perf_counter()
                    got = g.epoch_steps(epoch).cpu()
                    t_graph = time.perf_counter() - t0
                    after = kernel_launch_counts()
                    t0 = time.perf_counter()
                    want = e.epoch_steps(epoch).cpu()
                    t_eager = time.perf_counter() - t0
                if calls:
                    raise RuntimeError(f"{name} {route} epoch {epoch}: {len(calls)} calls into "
                                       f"the autograd engine on the kernel path")
                n = want.shape[0]
                captured = len(g.graph_captures) > captures
                for m, t in (("graph", t_graph), ("eager", t_eager)):
                    sec[(m, captured)][0] += t
                    sec[(m, captured)][1] += n
                launched = {k: after[k] - before[k] for k in (
                    "train_pe", "fwd_pe", "adam", "point_features", "lora_pack",
                    "lora_pack_vjp")}
                lora = n if name == "lora_trunk" else 0
                expect = {"train_pe": n, "fwd_pe": n if name == "hierarchical" else 0, "adam": n,
                          "point_features": 0 if feats is None else n, "lora_pack": lora,
                          "lora_pack_vjp": lora}
                if launched != expect:
                    raise RuntimeError(f"{name} {route} epoch {epoch}: launches {launched}, "
                                       f"expected {expect}")
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise RuntimeError(f"{name} {route} epoch {epoch}: graph and eager losses "
                                       f"differ")
            for (k, p), (_, q) in zip(g.model.named_parameters(), e.model.named_parameters()):
                if not torch.equal(p.detach().view(torch.int32), q.detach().view(torch.int32)):
                    raise RuntimeError(f"{name} {route}: parameter {k} differs")
            for p, q in zip(g.optimizer.param_groups[0]["params"],
                            e.optimizer.param_groups[0]["params"]):
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    if not torch.equal(g.optimizer.state[p][key], e.optimizer.state[q][key]):
                        raise RuntimeError(f"{name} {route}: Adam {key} differs")
            if g.step_mode != "graph" or e.step_mode != "eager":
                raise RuntimeError(f"{name} {route}: step modes {g.step_mode}, {e.step_mode}")
            caps = ", ".join(f"phase {c['phase']} capture {c['capture_ms']:.1f} ms, instantiate "
                             f"{c['instantiate_ms']:.1f} ms, pool {c['pool_mb']:.1f} MB"
                             for c in g.graph_captures)
            ms = {k: t / n * 1e3 if n else float("nan") for k, (t, n) in sec.items()}
            steps = sec[("graph", False)][1] + sec[("graph", True)][1]
            print(f"  {name} {route}: {steps} steps over epochs {GRAPH_GATE_EPOCHS[name]} "
                  f"bit-equal (losses, parameters, moments, steps); ms per step over the "
                  f"{sec[('graph', False)][1]} steps of the epochs that only replayed: graph "
                  f"{ms[('graph', False)]:.3f}, eager {ms[('eager', False)]:.3f}; over the "
                  f"{sec[('graph', True)][1]} of the epochs that captured: graph "
                  f"{ms[('graph', True)]:.3f}, eager {ms[('eager', True)]:.3f} "
                  f"({e.step_mode_reason}); captures: {caps}", flush=True)
            if route == "float32":
                out[name] = ms[("graph", False)]
            del g, e
    return out


def no_sync_run(label, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: raises at
    the first call that would make the host wait for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  {label}: no synchronization under set_sync_debug_mode('error')", flush=True)
    return out


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
    consts = tk.pe_constants(cfg.nerf.pos_freq, cfg.nerf.dir_freq, viewdirs,
                             0 if feats is None else feats.shape[1], device)
    packed = tk.pack_params(trainer.model.state_dict(), cfg.nerf.num_layers,
                            cfg.nerf.hidden_dim, d_pad=tk.pe_width(consts.x_dim),
                            row_perm=consts.row_perm, lora_alpha=cfg.nerf.lora_alpha)
    return (tk._raw_block(pts, rd, viewdirs), feats, z,
            torch.linalg.norm(rd, dim=-1, keepdim=True), consts.e2, consts.c, packed)


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
    the same seed, and return the launches of (train_pe, train_x), the
    trained trainer, epoch 0's per-step losses of both trainers and the
    Adam kernel's launches (one per step: the trainer steps as graph
    replays)."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.optim import AdamKernel
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
    AdamKernel.launches = 0
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
    counts = {**tt.fused_train_objective.launches, "adam": AdamKernel.launches}
    print(f"  launches: {counts} for {steps} steps; steps as {ktr.step_mode} replays", flush=True)
    if counts["train_pe"] != steps or counts["adam"] != steps or ktr.step_mode != "graph":
        raise RuntimeError(f"{counts} kernel launches for {steps} steps, as {ktr.step_mode}")
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
        if e == TRAIN_EPOCHS[0]:
            plain0 = ptr.last_step_losses.copy()
            if not rel.max() <= TRAIN_LOSS_RTOL:
                raise RuntimeError(f"epoch {e}: kernel and plain trainers differ by rel "
                                   f"{rel.max()} (tol {TRAIN_LOSS_RTOL})")
    epoch0 = {"kernel": kernel_losses[TRAIN_EPOCHS[0]], "plain": plain0}
    if ptr.step_mode != "eager" or "plain path" not in ptr.step_mode_reason:
        raise RuntimeError(f"the plain trainer steps as {ptr.step_mode}: {ptr.step_mode_reason}")
    print(f"  plain trainer steps eagerly: {ptr.step_mode_reason}", flush=True)
    return counts["train_pe"], counts["train_x"], ktr, epoch0, counts["adam"]


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
    time of the call; the sampler kernel once per chunk and per analysis
    view with DINO features, never on the plain harness. Returns kernel 2's
    and the sampler's launches in the call."""
    import contextlib
    import io

    from nerf_fewshot_tpu_torch import cli as tcli
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features as spf
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
    spf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        tcli.main(["evaluate", "--config", os.path.join(ROOT, "experiments", name),
                   "--checkpoint", ckpt, "--synthetic", "--output", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.fused_render_fwd_pe.launches
    sampler_launches = spf.launches
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
    # the sampler: once per chunk, once per view of the consistency matrix,
    # of the raw feature smoothness (two views) and of the field's smoothness
    want_sampler = launches + N_TRAIN_VIEWS + 2 + 1 if trainer.use_dino else 0
    print(f"  cli evaluate {name}: the sampler kernel {sampler_launches} launches (want "
          f"{want_sampler}: one per chunk and per analysis view)", flush=True)
    if sampler_launches != want_sampler:
        raise RuntimeError(f"{name}: evaluate launched the sampler {sampler_launches} times")

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
    spf.launches = 0
    pres = comprehensive_evaluation(plain, os.path.join(tmp, "plain"), n_orbit=N_ORBIT)
    if tk.fused_render_fwd_pe.launches or spf.launches:
        raise RuntimeError("the plain harness launched kernel 2 or the sampler")
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
    return launches, sampler_launches


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


def render_stepper(cfg, pd, device, n_importance, fused, compute_dtype="float32", trainer=None):
    """A function that takes one Adam step of the baseline ``NeRFMLP`` (its
    init from ``cfg.seed``, or a copy of ``trainer``'s model with its train
    view 0 features) on a batch of the last phase's shape (512 rays x 64
    jittered samples of the 128x128 views) and returns its loss, a loss on
    every output of the render:
    rgb MSE + 0.01 mean(w^2) + 1e-3 mean(|depth - 4|) + 1e-3 mean(acc),
    through ``fused_render_rays(forward_only=False)`` (``fused``) or the
    plain ``render_rays`` and autograd. Batches and uniforms come from a
    generator seeded with ``cfg.seed``, so both routes see the same ones."""
    import copy

    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
    from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
    from nerf_fewshot_tpu_torch.training.optim import make_optimizer

    n = cfg.nerf
    pf = None
    if trainer is None:
        model = NeRFMLP(pos_freq=n.pos_freq, dir_freq=n.dir_freq, use_viewdirs=n.use_viewdirs,
                        hidden_dim=n.hidden_dim, num_layers=n.num_layers,
                        sigma_bias_init=n.sigma_bias,
                        generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    else:
        model, pf = copy.deepcopy(trainer.model), trainer.feature_sampler(0)
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
                                    n.use_viewdirs, compute_dtype=compute_dtype,
                                    device=device, uniforms=u, importance_uniforms=ui,
                                    point_features_fn=pf)
        else:
            out = render_rays(model, ro, rd, settings, u, ui, point_features_fn=pf)
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
    no_sync_run(f"hierarchical epoch {TRAIN_EPOCHS[-1]}'s steps",
                lambda: tr.epoch_steps(TRAIN_EPOCHS[-1]))
    no_sync_run("hierarchical render_views_device of 2 test views",
                lambda: tr.render_views_device(test.poses[:2]))

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
    ``kernel_path``; under ``backend: fused`` it raises. Width 640 (the JAX
    kernels take it, and the port's width-generic build) trains the epoch
    through kernel 1 under ``auto``, once per step."""
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
    try:
        Trainer(config_from_dict({**SMOKE_CONFIG, "rendering": {
            **SMOKE_CONFIG["rendering"], "backend": "fused"}}), train, device=device).train_epoch(0)
    except ValueError as err:
        print(f"  width 64, backend fused: raises ({err})", flush=True)
    else:
        raise RuntimeError("width 64, backend fused trained on the card")
    wide = Trainer(config_from_dict({**SMOKE_CONFIG, "nerf_model": {
        **SMOKE_CONFIG["nerf_model"], "hidden_dim": 640}}), train, device=device)
    before = tt.fused_train_objective.launches["train_pe"]
    loss = wide.train_epoch(0)
    steps = len(wide.last_step_losses)
    launched = tt.fused_train_objective.launches["train_pe"] - before
    print(f"  width 640, backend auto: {steps} steps, loss {loss:.6f}, kernel_path "
          f"{wide.kernel_path} ({wide.kernel_path_reason}), {launched} kernel-1 launches",
          flush=True)
    if not np.isfinite(loss) or wide.kernel_path != "kernel" or launched != steps:
        raise RuntimeError(f"width 640: loss {loss}, path {wide.kernel_path}, {launched} "
                           f"launches for {steps} steps")


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


# The feature sampler kernel (csrc/point_features.cu) at the shipped
# configs' shapes: name -> (points: rays x samples of the config's phase-2
# step, the map stack (V, Hp, Wp, Fd): 5 train views of the extractor's grid,
# projection, align_corners, invalid_fill). Every case samples view
# SAMPLER_VIEW, its index read from the device.
SAMPLER_CASES = {
    "dino_nerf": (256 * 64, (5, 9, 9, 64), "reference", False, "zeros"),
    "lora_nerf_trunk": (512 * 64, (5, 9, 9, 64), "reference", False, "zeros"),
    "multiscale": (256 * 64, (5, 9, 9, 128), "reference", False, "zeros"),
    "script": (4096 * 64, (5, 14, 14, 768), "script", True, "zeros"),
    "mean": (256 * 64, (5, 9, 9, 128), "reference", False, "mean"),
}
SAMPLER_VIEW = 3
SAMPLER_ROW = "dino_nerf"  # the kernels line's shape
# Kernel vs plain: the plain version's 4x4 projection is cuBLAS's product,
# whose order of the four terms is not known; a coordinate moves by a few
# ulps, and a bilinear tap is continuous, so a feature moves by at most the
# coordinate's error times the largest neighbour difference: 1e-5 of the
# map's largest value. valid may differ only where |z| < SAMPLER_Z_TIE.
SAMPLER_TOL, SAMPLER_Z_TIE, SAMPLER_MEAN_RTOL = 1e-5, 1e-6, 1e-6


def sampler_points(rng, n, c2w, focal, res, map_hw, align_corners, projection):
    """``n`` points made from ``rng`` around the camera ``c2w`` (float64,
    then fp32): an eighth in front of and behind the camera at the map's
    integer coordinates, on its pixel edges and off it (image x, y chosen,
    then carried back through the pinhole of ``projection``: camera
    ``R^T (p - t)`` for the reference one, ``R (p - t)`` for the script
    one), a sixteenth at integer world coordinates, the rest uniform in the
    scene's [-2, 2]^3."""
    Hp, Wp = map_hw
    n_edge, n_int = n // 8, n // 16
    marks = []
    for size in (Wp, Hp):
        k = np.arange(-1, size + 1, dtype=np.float64)
        grid = k * res / (size - 1) if align_corners else (k + 0.5) * res / size
        marks.append(np.concatenate([grid, k * res / size, [-10.0 * res, 11.0 * res]]))
    x = rng.choice(marks[0], n_edge)
    y = rng.choice(marks[1], n_edge)
    z = rng.uniform(2.0, 6.0, n_edge) * rng.choice([-1.0, 1.0], n_edge)
    cam = np.stack([(x - res / 2) / focal * z, (y - res / 2) / focal * z, z], axis=-1)
    c2w = np.asarray(c2w, np.float64)
    rot = c2w[:3, :3] if projection == "script" else c2w[:3, :3].T
    edge = cam @ rot + c2w[:3, 3]
    pts = np.concatenate([edge, rng.integers(-3, 4, (n_int, 3)).astype(np.float64),
                          rng.uniform(-2.0, 2.0, (n - n_edge - n_int, 3))])
    return pts[rng.permutation(n)].astype(np.float32)


def sampler_inputs(case, poses, focal, res, device, seed=20, spec=None):
    """The wrapper's arguments of ``SAMPLER_CASES[case]`` (or of ``spec``,
    a tuple of the same fields) on ``device``: seeded maps,
    ``sampler_points`` around view SAMPLER_VIEW of ``poses`` (the scene's
    train c2w), the pose stack the trainer passes (w2c by the single-view
    inverse, or c2w for the script projection), the view as a device
    tensor."""
    n, shape, projection, align, fill = spec or SAMPLER_CASES[case]
    rng = np.random.default_rng(seed)
    c2w = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    stack = c2w if projection == "script" else torch.stack(
        [torch.linalg.inv_ex(p)[0] for p in c2w])
    maps = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
    pts = sampler_points(rng, n, poses[SAMPLER_VIEW], focal, res, shape[1:3], align, projection)
    return dict(pts=torch.as_tensor(pts, device=device), maps=maps,
                view=torch.tensor([SAMPLER_VIEW], device=device), pose_mats=stack,
                focal=float(focal), H=res, W=res, align_corners=align, projection=projection,
                invalid_fill=fill)


def sampler_call(fn, a, **over):
    """``fn`` (the wrapper or its plain version) on the inputs ``a``."""
    kw = {**a, **over}
    return fn(kw.pop("pts"), kw.pop("maps"), kw.pop("view"), kw.pop("pose_mats"),
              kw.pop("focal"), kw.pop("H"), kw.pop("W"), **kw)


def sampler_depth(a):
    """Each point's camera z in the sampled view, as the plain version
    projects it."""
    from nerf_fewshot_tpu_torch.ops.rays import project_points_script, project_points_w2c

    pose = a["pose_mats"][SAMPLER_VIEW]
    proj = project_points_script if a["projection"] == "script" else project_points_w2c
    return proj(a["pts"], pose, a["focal"], a["H"], a["W"])[1]


def check_sampler(label, got, again, want, a, raw=None):
    """The kernel's ``(features, valid)`` against the plain version's on the
    same inputs, or raise: features within SAMPLER_TOL of the map's largest
    value, valid equal but where |z| < SAMPLER_Z_TIE, a second call
    bit-equal; under ``invalid_fill: mean`` (``raw``: the plain features
    before the fill) every invalid row the kernel's mean, which is within
    rel SAMPLER_MEAN_RTOL of the plain mean or no further from the float64
    mean than it. Returns the max abs error and prints the share of
    elements bit-equal to the plain version."""
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise RuntimeError(f"{label}: two calls differ")
    (f, valid), (pf, pvalid) = got, want
    if f.shape != pf.shape or not torch.isfinite(f).all():
        raise RuntimeError(f"{label}: features {tuple(f.shape)}, finite {bool(torch.isfinite(f).all())}")
    tol = SAMPLER_TOL * a["maps"].abs().max().item()
    err = (f - pf).abs().max().item()
    bits = (f.view(torch.int32) == pf.view(torch.int32)).double().mean().item()
    z = sampler_depth(a)
    flips = int(((valid != pvalid) & (z.abs() >= SAMPLER_Z_TIE)).sum())
    ties = int(((valid != pvalid) & (z.abs() < SAMPLER_Z_TIE)).sum())
    line = (f"  {label}: max abs err {err:.3e} (tol {tol:.3e}), {bits:.4%} of the "
            f"{f.numel()} elements bit-equal to the plain version, valid "
            f"{int(valid.sum())} of {valid.numel()}, {flips} flips ({ties} at |z| < "
            f"{SAMPLER_Z_TIE:.0e}); a second call bit-equal")
    if raw is not None:
        inv = ~valid
        if not inv.any():
            raise RuntimeError(f"{label}: no invalid point to fill")
        mean = f[inv.nonzero()[0, 0]]
        pmean = pf[(~pvalid).nonzero()[0, 0]]
        m64 = raw.double().mean(dim=0)
        if not torch.equal(f[inv], mean.expand(int(inv.sum()), -1)):
            raise RuntimeError(f"{label}: the invalid rows are not all the mean")
        rel = (mean - pmean).abs() / pmean.abs()
        closer = (mean.double() - m64).abs() <= (pmean.double() - m64).abs()
        line += (f"; mean rel {rel.max().item():.3e} to the plain mean (tol "
                 f"{SAMPLER_MEAN_RTOL:.0e}; {int((rel > SAMPLER_MEAN_RTOL).sum())} channels past "
                 f"it, each no further from the float64 mean than the plain one), float64 "
                 f"distance kernel {(mean.double() - m64).abs().max().item():.3e}, plain "
                 f"{(pmean.double() - m64).abs().max().item():.3e}")
        if not ((rel <= SAMPLER_MEAN_RTOL) | closer).all():
            raise RuntimeError(f"{label}: the kernel's mean is off the plain one: {line}")
    print(line, flush=True)
    if not err <= tol or flips:
        raise RuntimeError(f"{label}: features off by {err} (tol {tol}), {flips} valid flips")
    return err


def sampler_cost(a):
    """The bytes the sampler must move: each point read, the view's map
    read, each feature and valid flag written once."""
    n, (_, Hp, Wp, Fd) = a["pts"].shape[0], a["maps"].shape
    return n * 12 + Hp * Wp * Fd * 4 + n * Fd * 4 + n


def sampler_ms_pair(trainer, pts, iters):
    """CUDA-event ms of ``trainer``'s view-0 sampler at ``pts``: the kernel
    (the closure the kernel path takes on a card) and the plain sampler
    (``_feature_sampler`` on the view's map and pose) on the same points."""
    from nerf_fewshot_tpu_torch.training.trainer import _feature_sampler

    d = trainer.cfg.dino
    pf = trainer.feature_sampler(0)
    plain = _feature_sampler(trainer.dino_features[0], trainer._poses_t[0], trainer.focal,
                             trainer.H, trainer.W, align_corners=d.align_corners,
                             invalid_fill=d.invalid_fill, projection=d.projection)
    return cuda_ms(lambda: pf(pts), iters=iters), cuda_ms(lambda: plain(pts), iters=iters)


def graph_ms(fn, calls=20, reps=5):
    """Device ms per call of ``fn()``, which only enqueues work: ``calls``
    calls captured into one CUDA graph (after a warm-up on a side stream),
    replayed ``reps`` times between CUDA events, so the host's launch cost
    is out of the reading (a microsecond kernel launched from Python is
    otherwise timed at the host's pace)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def run_sampler_kernel(train, device):
    """``sample_point_features_valid`` (``csrc/point_features.cu``) against
    its plain version on the card at SAMPLER_CASES (the scene's train poses
    and focal, the full resolution), ``check_sampler``'s gates, the launches
    counted (one a call, four with the mean); ``invalid_fill: mean`` also on
    two Gloo ranks (``dp_runs.sampler_rank``: each rank's half of the
    points, the per-channel sums all-reduced between the launches) against
    the plain version on one process over all the points; the device ms of
    the kernel and the plain version (``graph_ms``; beside them a loop of
    calls from the host, CUDA events), the byte bound and share,
    ``F.grid_sample``'s ms for the taps alone (a yardstick for part of the
    function: the port never calls it) and the ms of one read and write of
    the (N, Fd) feature block (a copy: what folding the sampler into kernels
    1 and 2 would still save). Returns ``{case: dict of the numbers}``."""
    import torch.nn.functional as F

    from nerf_fewshot_tpu_torch.ops.rays import project_points_script, project_points_w2c
    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.render import point_features as tpf
    from nerf_fewshot_tpu_torch.tools import dp_runs

    res = train.H
    rows = {}
    for case in SAMPLER_CASES:
        a = sampler_inputs(case, train.poses, train.focal, res, device)
        before = tpf.sample_point_features.launches
        got = sampler_call(tpf.sample_point_features_valid, a)
        calls = tpf.sample_point_features.launches - before
        again = sampler_call(tpf.sample_point_features_valid, a)
        want = sampler_call(tpf.point_features_reference, a)
        raw = None
        if a["invalid_fill"] == "mean":
            raw = sampler_call(tpf.point_features_reference, a, invalid_fill="zeros")[0]
        n, shape = a["pts"].shape[0], tuple(a["maps"].shape)
        label = (f"{case}: {n} points, maps {shape}, {a['projection']}, align_corners "
                 f"{a['align_corners']}, {a['invalid_fill']}")
        err = check_sampler(label, got, again, want, a, raw)
        if calls != (4 if raw is not None else 1):
            raise RuntimeError(f"{case}: {calls} launches counted")
        kernel = lambda: sampler_call(tpf.sample_point_features, a)
        plain = lambda: sampler_call(tpf.point_features_reference, a)
        k_ms, p_ms = graph_ms(kernel), graph_ms(plain, calls=5)
        k_loop_ms, p_loop_ms = cuda_ms(kernel, iters=50), cuda_ms(plain, iters=10)
        block = want[0].clone()
        fold_ms = graph_ms(lambda: block.copy_(want[0]))
        nbytes = sampler_cost(a)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        pose = a["pose_mats"][SAMPLER_VIEW]
        proj = project_points_script if a["projection"] == "script" else project_points_w2c
        grid = proj(a["pts"], pose, a["focal"], res, res)[0].reshape(1, 1, n, 2).contiguous()
        image = a["maps"][SAMPLER_VIEW].permute(2, 0, 1)[None].contiguous()
        taps = lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=a["align_corners"])
        g_ms = graph_ms(taps)
        taps_err = (taps()[0, :, 0].T - raw if raw is not None else
                    taps()[0, :, 0].T - want[0]).abs().max().item()
        rows[case] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bytes=nbytes, grid_sample_ms=g_ms, launches_per_call=calls,
                          points=n, maps=shape, ms_event_loop=k_loop_ms,
                          plain_ms_event_loop=p_loop_ms, fold_remainder_ms=fold_ms)
        print(f"  {case}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (device, graph replays; "
              f"a loop of calls from the host: {k_loop_ms:.4f} / {p_loop_ms:.4f} ms), bound "
              f"{b_ms:.4f} ms by bytes ({nbytes / 1e6:.2f} MB; share {b_ms / k_ms:.1%}); "
              f"F.grid_sample of the taps alone {g_ms:.4f} ms (a yardstick for part of the "
              f"function, off the plain taps by {taps_err:.1e}; the port never calls it); the "
              f"(N, Fd) block's read and write (a copy of the features, what a fold into kernels "
              f"1 and 2 would still save) {fold_ms:.4f} ms", flush=True)

    # invalid_fill mean over two ranks' shards, against one process over all
    a = sampler_inputs("mean", train.poses, train.focal, res, device)
    want = sampler_call(tpf.point_features_reference, a)
    raw = sampler_call(tpf.point_features_reference, a, invalid_fill="zeros")[0]
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in a.items()}
    t0 = time.perf_counter()
    two = pmesh.launch(dp_runs.sampler_rank, [device, device], (host,), backend="gloo",
                       timeout_s=600)
    sec = time.perf_counter() - t0
    for r, t in enumerate(two):
        if t["launches"] != 4 * 2:
            raise RuntimeError(f"mean on two ranks: rank {r} counted {t['launches']} launches")
        if not np.array_equal(t["kernel"][0], t["again"][0]):
            raise RuntimeError(f"mean on two ranks: rank {r}'s two calls differ")
        if not np.array_equal(t["kernel"][0], t["plain"][0]) and \
                np.abs(t["kernel"][0] - t["plain"][0]).max() > \
                SAMPLER_TOL * np.abs(host["maps"]).max():
            raise RuntimeError(f"mean on two ranks: rank {r}'s kernel off its plain version")
    cat = lambda key, i: torch.as_tensor(np.concatenate([t[key][i] for t in two]), device=device)
    err = check_sampler("mean on two Gloo ranks (each half the points, the sums all-reduced) "
                        f"vs one process, {sec:.1f} s with start-up",
                        (cat("kernel", 0), cat("kernel", 1)), (cat("again", 0), cat("again", 1)),
                        want, a, raw)
    rows["mean"]["max_abs_err_two_ranks"] = err
    return rows


def run_dino_slice(name, train, test, device, tk, tt, feats=None, epochs=None, label=None):
    """``experiments/<name>`` through the port's ``load_config`` at full
    width: the extractor (ViT-B/14, 12x768) on the card, one feature map per
    training view (or the given ``feats``); ``evaluate`` at init (kernel 2
    with train view 0's features, one launch per chunk); ``train_epoch`` at
    ``epochs`` (default DINO_EPOCHS, one for lora.yaml), every step
    launching kernel 1 once with the view's features; epoch 0's per-step
    losses against a ``backend: xla`` trainer from the same seed, batches
    and features; PSNR after training above PSNR at init; the views against
    the plain pipeline with the trained weights; kernel 1 and kernel 2
    against their plain versions at the trainer's own step and eval-chunk
    shapes; for the default ``dino_nerf.yaml`` run, one traced epoch.
    ``label`` names the run in the output. Returns a dict of the
    numbers."""
    from nerf_fewshot_tpu_torch.cli import _precompute_features
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features as spf
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = load_config(os.path.join(ROOT, "experiments", name))
    traced = name == "dino_nerf.yaml" and epochs is None
    if epochs is None:
        epochs = DINO_EPOCHS if name != "lora.yaml" else DINO_EPOCHS[:1]
    name = label or name
    fd, d = DINO_WIDTHS[cfg.dino.model_type]
    widths = (cfg.nerf.hidden_dim, cfg.nerf.num_layers, cfg.nerf.pos_freq, cfg.dino.output_dim,
              cfg.data.resolution, cfg.data.num_views, cfg.rendering.chunk_size)
    if widths != (256, 8, 12, fd, 128, N_TRAIN_VIEWS, 1024):
        raise RuntimeError(f"{name}: widths {widths}")
    extract_s = None
    if feats is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = _precompute_features(cfg, train, device)
        extract_s = time.perf_counter() - t0
        lora = cfg.dino.lora_rank if cfg.dino.use_lora else 0
        print(f"  {name}: {cfg.dino.model_type} extractor, ViT-B/14 12x768, LoRA rank {lora} -> "
              f"feature maps {tuple(feats.shape)} in {extract_s:.2f} s (build and "
              f"{train.n_views} views)", flush=True)
    if feats.shape != (N_TRAIN_VIEWS, 9, 9, fd) or not np.isfinite(feats).all():
        raise RuntimeError(f"{name}: feature maps {feats.shape}")

    ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
    pcfg = config_from_dict({**cfg.raw, "rendering": {**cfg.raw["rendering"], "backend": "xla"}})
    ptr = Trainer(pcfg, train, test, device=device, dino_features=feats)
    if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
        raise RuntimeError(f"{name}: paths {ktr.kernel_path}, {ptr.kernel_path}")
    n_chunks = -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    tk.fused_render_fwd_pe.launches = 0
    spf.launches = 0
    psnr0 = ktr.evaluate()["psnr"]
    if tk.fused_render_fwd_pe.launches != n_chunks or spf.launches != n_chunks:
        raise RuntimeError(f"{name}: eval {tk.fused_render_fwd_pe.launches} kernel-2 and "
                           f"{spf.launches} sampler launches, {n_chunks} chunks")
    for e in epochs:
        ktr.phase_data(ktr._phase_index(e))

    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    spf.launches = 0
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
    sampler_launches = spf.launches
    print(f"  {name} launches: kernel 1 {launches}, the sampler kernel {sampler_launches} for "
          f"{steps} steps", flush=True)
    if launches != steps or sampler_launches != steps:
        raise RuntimeError(f"{name}: {launches} kernel-1 and {sampler_launches} sampler "
                           f"launches for {steps} steps")

    ptr.train_epoch(0)
    rel = np.abs(ptr.last_step_losses / losses0 - 1.0).max()
    print(f"  {name} epoch 0 vs the backend: xla trainer: per-step max rel {rel:.2e} "
          f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
    if not rel <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"{name}: epoch 0 kernel and plain trainers differ by rel {rel}")
    if spf.launches != sampler_launches:
        raise RuntimeError(f"{name}: the backend: xla trainer launched the sampler kernel")

    tk.fused_render_fwd_pe.launches = 0
    spf.launches = 0
    after = ktr.evaluate()
    eval_launches = tk.fused_render_fwd_pe.launches
    eval_sampler = spf.launches
    print(f"  {name} evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after "
          f"{steps} steps, ssim {after['ssim']:.5f}, {eval_ms(ktr)}, kernel 2 "
          f"{eval_launches} and the sampler {eval_sampler} launches for {n_chunks} chunks",
          flush=True)
    if eval_launches != n_chunks or eval_sampler != n_chunks:
        raise RuntimeError(f"{name}: eval launched kernel 2 {eval_launches} and the sampler "
                           f"{eval_sampler} times")
    if name != "lora.yaml" and not after["psnr"] > psnr0:
        raise RuntimeError(f"{name}: psnr after training {after['psnr']} <= at init {psnr0}")

    ptr.model.load_state_dict(ktr.model.state_dict())
    got = ktr.render_views(test.poses)
    before = spf.launches
    want = ptr.render_views(test.poses)
    if spf.launches != before:
        raise RuntimeError(f"{name}: the backend: xla trainer's eval launched the sampler")
    errs = {out: float(np.abs(g - w).max()) for g, w, out in zip(got, want, ("rgb", "depth", "acc"))}
    print(f"  {name} views vs the plain pipeline (trained weights): max abs err " + ", ".join(
        f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items()), flush=True)
    if not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items()):
        raise RuntimeError(f"{name}: kernel-rendered views disagree with the plain pipeline {errs}")

    # the kernels against their plain versions at the trainer's own shapes
    out = dict(launches=launches, eval_launches=eval_launches, step_ms=step_ms, fd=fd, d=d,
               psnr0=psnr0, psnr=after["psnr"], extract_s=extract_s, trainer=ktr,
               sampler_launches=sampler_launches + eval_sampler)
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
    out["sampler_ms"], out["sampler_plain_ms"] = sampler_ms_pair(ktr, pts, iters=20)
    print(f"  {name} at the step's shape: kernel 1 {out['train_ms']:.3f} ms, feature sampling of "
          f"{R * S} points {out['sampler_ms']:.4f} ms by the kernel, {out['sampler_plain_ms']:.4f} "
          f"ms by the plain sampler (CUDA events)", flush=True)
    if traced:
        epoch = DINO_EPOCHS[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ktr.train_epoch(epoch)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        for with_cpu in (False, True):
            print_trace(f"{name} epoch {epoch} traced ({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                        trace_epoch(ktr, epoch, with_cpu), untraced_ms, max_syncs=1)
        no_sync_run(f"{name} epoch {epoch}'s steps", lambda: ktr.epoch_steps(epoch))
        no_sync_run(f"{name} render_views_device of 2 test views",
                    lambda: ktr.render_views_device(test.poses[:2]))
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


def random_lora_state(rng, in_dim, H, L, rank, device):
    """A LoRA trunk's state in ``NeRFMLP.named_parameters``' order:
    torch-default-bounded weights and biases, ``lora_a`` bounded alike,
    ``lora_b`` live (``N(0, 0.05^2)``; a model starts it at zero)."""
    u = lambda shape, fan: rng.uniform(-1, 1, shape).astype(np.float32) / np.float32(fan ** 0.5)
    state = {}
    for i in range(L):
        fan = in_dim if i == 0 else H
        state[f"trunk.{i}.lora_a"] = u((fan, rank), fan)
        state[f"trunk.{i}.lora_b"] = (0.05 * rng.standard_normal((rank, H))).astype(np.float32)
        state[f"trunk.{i}.base.weight"] = u((H, fan), fan)
        state[f"trunk.{i}.base.bias"] = u((H,), fan)
    state.update({"sigma_head.weight": u((1, H), H), "sigma_head.bias": np.full(1, 0.1, np.float32),
                  "rgb_head.weight": u((3, H), H), "rgb_head.bias": u((3,), H)})
    return {k: torch.from_numpy(v).to(device) for k, v in state.items()}


def bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def rel_dist(got, want):
    """``||got - want|| / ||want||`` over the tensors of two lists, in float64."""
    d = sum(float(torch.sum((g.double() - w.double()) ** 2)) for g, w in zip(got, want))
    n = sum(float(torch.sum(w.double() ** 2)) for w in want)
    return (d / n) ** 0.5 if n else d ** 0.5


def lora_pack_bounds(in_dim, H, L, r, fwd_bytes, vjp_bytes):
    """``{"fwd" / "vjp": (bound_ms, bound_by, rate)}`` of the LoRA pack
    kernels: the larger of the bytes at the HBM rate and the operations (2 r
    a merged element, a product and a sum; 4 r in the VJP's two reductions)
    at the peak of their type: the forward's fp32 sums up to
    ``lora_pack.TORCH_ORDER_RANK``, float64 above it; the VJP's float64
    sums at every rank."""
    from nerf_fewshot_tpu_torch.render.lora_pack import TORCH_ORDER_RANK

    merged = (in_dim + (L - 1) * H) * H
    out = {}
    for key, nbytes, ops, f64 in (("fwd", fwd_bytes, 2 * r * merged, r > TORCH_ORDER_RANK),
                                  ("vjp", vjp_bytes, 4 * r * merged, True)):
        ops_s = ops / (FP64_FLOPS if f64 else FP32_FLOPS)
        bytes_s = nbytes / HBM_BYTES_PER_S
        out[key] = (max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes",
                    "fp64 at 34 TFLOP/s" if f64 else "fp32 at 67 TFLOP/s")
    return out


def run_lora_pack_kernels(device):
    """``lora_pack`` / ``lora_pack_vjp`` (``csrc/lora_pack.cu``) against their
    plain versions at LORA_PACK_CASES, each with the inline-PE layout's
    ``row_perm``, seeded weights and packed cotangents (a third of them
    -0.0): the six packed tensors bit-equal to ``_pack_merged`` up to rank
    ``lp.TORCH_ORDER_RANK`` (above it the merged weights within
    LORA_PACK_FWD_RTOL of it and no further from a float64 packing, the
    rest bit-equal), the base, bias and head gradients bit-equal to
    autograd's, ``lora_a`` / ``lora_b`` within LORA_PACK_VJP_RTOL of
    autograd and no further from a float64 run than autograd, a second call
    of each bit-equal, ceil(L / 32) launches of each, or raise. Device ms
    (``graph_ms``) of each kernel, of each plain version and of
    ``torch.baddbmm`` over layers 1.. of the merge (TF32 off: a partial
    yardstick, no layer 0, no permutation, no heads), and the bounds
    (``lora_pack_bounds``). Returns ``{case: row}``."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.render import lora_pack as lp

    rows = {}
    for n_case, (label, (pos, dirs, vd, fd, H, L, r)) in enumerate(LORA_PACK_CASES.items()):
        consts = tk.pe_constants(pos, dirs, vd, fd, device)
        in_dim, d_pad, perm = consts.x_dim, tk.pe_width(consts.x_dim), consts.row_perm
        rng = np.random.default_rng(250 + n_case)
        state = random_lora_state(rng, in_dim, H, L, r, device)
        args = (L, H, d_pad, perm, 16.0)
        launches = len(lp.launch_layers(L))
        before = (lp.lora_pack.launches, lp.lora_pack_vjp.launches)
        got, want, again = lp.lora_pack(state, *args), lp.lora_pack_reference(state, *args), \
            lp.lora_pack(state, *args)
        bad = [k for k, (g, a) in enumerate(zip(got, again)) if not bit_equal(a, g)]
        fwd_note = "bit-equal to _pack_merged"
        if r <= lp.TORCH_ORDER_RANK:
            bad += [k for k, (g, w) in enumerate(zip(got, want)) if not bit_equal(g, w)]
        else:  # the kernel's float64 sums
            exact = lp.lora_pack_reference({k: v.double() for k, v in state.items()}, *args)
            fwd_rel = max(rel_dist([g], [w]) for g, w in zip(got, want))
            gaps = [rel_dist([g], [e]) - rel_dist([w], [e]) for g, w, e in zip(got, want, exact)]
            bad += [k for k, (g, w) in enumerate(zip(got, want))
                    if rel_dist([g], [w]) > LORA_PACK_FWD_RTOL or gaps[k] > 0
                    or (k not in (0, 2) and not bit_equal(g, w))]
            fwd_note = (f"within rel {fwd_rel:.2e} of _pack_merged (tol "
                        f"{LORA_PACK_FWD_RTOL:.0e}; float64 sums above rank "
                        f"{lp.TORCH_ORDER_RANK}), from a float64 packing w0 / wh "
                        f"{rel_dist([got[0]], [exact[0]]):.3e} / "
                        f"{rel_dist([got[2]], [exact[2]]):.3e}, plain "
                        f"{rel_dist([want[0]], [exact[0]]):.3e} / "
                        f"{rel_dist([want[2]], [exact[2]]):.3e}, heads and biases bit-equal")
            del exact
        if bad:
            raise RuntimeError(f"lora_pack {label}: packed tensors {bad} fail their gate against "
                               f"the plain version (or differ from a second call)")
        g = torch.Generator().manual_seed(n_case)
        cots = []
        for w in want:
            c = torch.randn(w.shape, generator=g)
            c[c.abs() < 0.45] = -0.0
            cots.append(c.to(device))
        cots = tuple(cots)
        vargs = (L, H, perm, 16.0)
        kg, ag = lp.lora_pack_vjp(state, cots, *vargs), lp.lora_pack_vjp_reference(state, cots,
                                                                                    *vargs)
        k2 = lp.lora_pack_vjp(state, cots, *vargs)
        counted = (lp.lora_pack.launches - before[0], lp.lora_pack_vjp.launches - before[1])
        if counted != (2 * launches, 2 * launches):
            raise RuntimeError(f"{label}: launches {counted} for two calls of each, expected "
                               f"{launches} a call")
        f64 = lp.lora_pack_vjp_reference({k: v.double() for k, v in state.items()},
                                         tuple(c.double() for c in cots), *vargs)
        lora = [k for k in state if "lora" in k]
        bad = [k for k in state if not bit_equal(k2[k], kg[k])
               or ("lora" not in k and not bit_equal(kg[k], ag[k]))]
        rel = max(rel_dist([kg[k]], [ag[k]]) for k in lora)
        # each LoRA tensor's distance from float64, the kernel's against autograd's
        f64_gap = {k: rel_dist([kg[k]], [f64[k]]) - rel_dist([ag[k]], [f64[k]]) for k in lora}
        worst = max(f64_gap, key=f64_gap.get)
        d_k, d_p = rel_dist([kg[worst]], [f64[worst]]), rel_dist([ag[worst]], [f64[worst]])
        del f64
        print(f"  {label} (D {d_pad}, {L}x{H}, rank {r}, {launches} launch"
              f"{'es' if launches > 1 else ''} of each): packed weights {fwd_note}; VJP base, "
              f"bias and head gradients "
              f"{'bit-equal' if not bad else 'DIFFER: ' + str(bad[:4])} to autograd, lora_a / "
              f"lora_b max rel {rel:.2e} (tol {LORA_PACK_VJP_RTOL:.0e}), from float64 per "
              f"tensor: worst gap {worst} kernel {d_k:.3e} / autograd {d_p:.3e}, "
              f"{sum(v <= 0 for v in f64_gap.values())} of {len(lora)} no further; second "
              f"calls bit-equal", flush=True)
        if bad or not rel <= LORA_PACK_VJP_RTOL or not f64_gap[worst] <= 0:
            raise RuntimeError(f"lora_pack_vjp {label}: {bad}, rel {rel}, f64 {worst} {d_k} vs "
                               f"{d_p}")

        out = lp.pack_buffer(L, H, d_pad, device)
        gbuf = torch.empty(sum(v.numel() for v in state.values()), device=device)
        wt = torch.stack([state[f"trunk.{i}.base.weight"].T for i in range(1, L)])
        a_s = torch.stack([state[f"trunk.{i}.lora_a"] for i in range(1, L)])
        b_s = torch.stack([state[f"trunk.{i}.lora_b"] for i in range(1, L)])
        ms = {"fwd": graph_ms(lambda: lp.lora_pack(state, *args, out=out)),
              "vjp": graph_ms(lambda: lp.lora_pack_vjp(state, cots, *vargs, out=gbuf)),
              "fwd_plain": graph_ms(lambda: lp.lora_pack_reference(state, *args), calls=5),
              "vjp_plain": graph_ms(lambda: lp.lora_pack_vjp_reference(state, cots, *vargs),
                                    calls=5),
              "baddbmm": graph_ms(lambda: torch.baddbmm(wt, a_s, b_s, alpha=16.0 / r))}
        n_state = sum(v.numel() for v in state.values())
        n_packed = sum(w.numel() for w in want)
        n_lora = sum(state[k].numel() for k in lora)
        fwd_bytes = 4 * (n_state + n_packed) + 8 * in_dim
        # the VJP reads only the packed gradients that reach a parameter: gw0's
        # in_dim live rows, gwh, the biases, wout's columns 0-3 and bout's 0-3
        n_live = in_dim * H + (L - 1) * H * H + L * H + 4 * H + 4
        vjp_bytes = 4 * (n_live + n_lora + n_state) + 8 * in_dim
        bounds_ = lora_pack_bounds(in_dim, H, L, r, fwd_bytes, vjp_bytes)
        bound = {k: v[0] for k, v in bounds_.items()}
        print(f"  {label} device ms (20 calls in a CUDA graph): lora_pack_fwd {ms['fwd']:.4f} "
              f"(bound {bound['fwd']:.4f} by {bounds_['fwd'][1]} ({bounds_['fwd'][2]}), "
              f"{fwd_bytes / 1e6:.2f} MB, share {bound['fwd'] / ms['fwd']:.1%}), plain "
              f"{ms['fwd_plain']:.4f}; lora_pack_vjp {ms['vjp']:.4f} (bound {bound['vjp']:.4f} "
              f"by {bounds_['vjp'][1]} ({bounds_['vjp'][2]}), {vjp_bytes / 1e6:.2f} MB, share "
              f"{bound['vjp'] / ms['vjp']:.1%}), plain (autograd) {ms['vjp_plain']:.4f}; "
              f"torch.baddbmm of layers 1-{L - 1}'s merge {ms['baddbmm']:.4f}", flush=True)
        err = {"fwd": max(float((g - w).abs().max()) for g, w in zip(got, want)),
               "vjp": max(float((kg[k] - ag[k]).abs().max()) for k in state)}
        rows[label] = {"ms": ms, "bound_ms": bound,
                       "bound_by": {k: v[1] for k, v in bounds_.items()},
                       "bound_rate": {k: v[2] for k, v in bounds_.items()},
                       "bytes": {"fwd": fwd_bytes, "vjp": vjp_bytes},
                       "max_abs_err": err, "launches_a_call": launches,
                       "vjp_rel": rel, "vjp_f64": d_k, "vjp_plain_f64": d_p,
                       "shape": f"D {d_pad}, {L}x{H}, rank {r}"}
        del got, want, again, kg, ag, k2, out, gbuf, wt, a_s, b_s
    return rows


@contextmanager
def autograd_calls():
    """Count the calls into the autograd engine (``torch.autograd.grad`` and
    ``torch.autograd.backward``, through which ``Tensor.backward`` goes)
    made inside the block: yields a list, one entry a call."""
    calls, grad, backward = [], torch.autograd.grad, torch.autograd.backward

    def counted(fn, name):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    torch.autograd.grad, torch.autograd.backward = (counted(grad, "grad"),
                                                    counted(backward, "backward"))
    try:
        yield calls
    finally:
        torch.autograd.grad, torch.autograd.backward = grad, backward


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
    from nerf_fewshot_tpu_torch.render.lora_pack import lora_pack, lora_pack_vjp
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
    lora_pack.launches = lora_pack_vjp.launches = 0
    psnr0 = ktr.evaluate()["psnr"]
    if tk.fused_render_fwd_pe.launches != n_chunks:
        raise RuntimeError(f"eval {tk.fused_render_fwd_pe.launches} launches, {n_chunks} chunks")
    out = {"eval_packs": lora_pack.launches}
    if lora_pack.launches != 1 or lora_pack_vjp.launches:
        raise RuntimeError(f"eval at init: {lora_pack.launches} packs, {lora_pack_vjp.launches} "
                           f"VJPs (one pack a render_views call, no VJP)")
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
    lora_pack.launches = lora_pack_vjp.launches = 0
    steps = 0
    for e in LORA_EPOCHS:
        if e == boundary:
            before = frozen(ktr)
            lora_b = {k: v.clone() for k, v in ktr.model.state_dict().items()
                      if k.endswith("lora_b")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd_calls() as calls:
            loss = ktr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if calls:
            raise RuntimeError(f"epoch {e}: the kernel-path steps called into the autograd "
                               f"engine {len(calls)} times ({sorted(set(calls))})")
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
    out["pack_launches"] = (lora_pack.launches, lora_pack_vjp.launches)
    print(f"  launches: kernel 1 {out['launches']}, lora_pack_fwd {lora_pack.launches}, "
          f"lora_pack_vjp {lora_pack_vjp.launches} for {steps} steps (graph replays counted per "
          f"replay), no call into the autograd engine", flush=True)
    if [out["launches"], *out["pack_launches"]] != [steps] * 3:
        raise RuntimeError(f"{out['launches']} kernel-1 launches, {out['pack_launches']} "
                           f"pack / VJP launches for {steps} steps")
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
    packs = lora_pack.launches
    after = ktr.evaluate()
    out["eval_launches"] = tk.fused_render_fwd_pe.launches
    out["eval_packs"] += lora_pack.launches - packs
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
    traces = {}
    for with_cpu in (False, True):
        traces[with_cpu] = trace_epoch(ktr, epoch, with_cpu)
        print_trace(f"epoch {epoch} traced ({'CPU+CUDA' if with_cpu else 'CUDA only'})",
                    traces[with_cpu], untraced_ms, max_syncs=1)
    t = traces[False]
    print(f"  phase-2 step traced: {t['events']:.1f} device events, device ms "
          f"{sum(t['parts'].values()):.4f}, other {t['parts'].get('other', 0.0):.4f}, "
          f"lora_pack_fwd {t['parts'].get('lora_pack_fwd', 0.0):.4f}, lora_pack_vjp "
          f"{t['parts'].get('lora_pack_vjp', 0.0):.4f}; host ms in the autograd engine "
          f"{traces[True]['host']['backward']:.4f}", flush=True)
    if traces[True]["host"]["backward"] > 0 or not all(
            t["parts"].get(k, 0.0) > 0 for k in ("lora_pack_fwd", "lora_pack_vjp")):
        raise RuntimeError("the traced LoRA-trunk epoch ran the autograd engine or missed a "
                           "LoRA pack kernel")
    out["trace"] = {"events": t["events"], "parts": t["parts"]}
    no_sync_run(f"epoch {epoch}'s steps", lambda: ktr.epoch_steps(epoch))
    out.update(psnr0=psnr0, psnr=after["psnr"], trainer=ktr, cfg=cfg, feats=feats, epoch=epoch)
    return out


def run_lora_cap_trainers(train, test, device, tk, tt, feats):
    """``lora_nerf_trunk.yaml`` (``sigma_bias: 0.1``) past the LoRA pack
    kernels' old caps, one LORA_CAP_CONFIGS override each, on the LoRA
    slice's feature maps: epoch 0 (32x32) through the kernels, every count
    set to 0 before it and read after: kernel 1 once a step, each LoRA pack
    kernel ceil(L / 32) times a step, no call into the autograd engine; the
    per-step losses within TRAIN_LOSS_RTOL of a ``backend: xla`` twin's
    (same seed, batches, jitter and maps); then test view 0 rendered by both
    from the kernel trainer's weights: kernel 2 once per chunk, one packing
    (ceil(L / 32) launches), the views within TOL. Returns ``{label:
    counts}``."""
    from nerf_fewshot_tpu_torch.render.lora_pack import launch_layers, lora_pack, lora_pack_vjp
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    _, base = lora_trunk_configs()
    out = {}
    for label, over in LORA_CAP_CONFIGS.items():
        raw = {**base.raw, "nerf_model": {**base.raw["nerf_model"], **over}}
        cfg = config_from_dict(raw)
        pcfg = config_from_dict({**raw, "rendering": {**raw["rendering"], "backend": "xla"}})
        ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
        ptr = Trainer(pcfg, train, test, device=device, dino_features=feats)
        if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
            raise RuntimeError(f"{label}: paths {ktr.kernel_path} ({ktr.kernel_path_reason}), "
                               f"{ptr.kernel_path}")
        n, p0 = cfg.nerf, cfg.phases[0]
        packs = len(launch_layers(n.num_layers))
        ptr.train_epoch(0)  # the twin first: its launches are not the path's
        pd = ktr.phase_data(0)
        tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
        tk.fused_render_fwd_pe.launches = 0
        lora_pack.launches = lora_pack_vjp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd_calls() as calls:
            loss = ktr.train_epoch(0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        steps = len(ktr.last_step_losses)
        counts = {"train_pe": tt.fused_train_objective.launches["train_pe"],
                  "lora_pack": lora_pack.launches, "lora_pack_vjp": lora_pack_vjp.launches}
        expect = {"train_pe": steps, "lora_pack": steps * packs, "lora_pack_vjp": steps * packs}
        rel = float(np.max(np.abs(ptr.last_step_losses / ktr.last_step_losses - 1.0)))
        d = tk.pe_width(tk.pe_layout(n.pos_freq, n.dir_freq, n.use_viewdirs, feats.shape[-1])[3])
        print(f"  {label} ({n.num_layers}x{n.hidden_dim}, rank {n.lora_rank}, D {d}): epoch 0 "
              f"({pd.H}x{pd.W}, {min(p0.batch_size, pd.rays_o.shape[1])} rays x "
              f"{p0.n_samples} samples) loss {loss:.6f}, {steps} steps, "
              f"{sec / steps * 1e3:.3f} ms/step; per-step max rel gap to the backend: xla twin "
              f"{rel:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); launches {counts} ({packs} a step of each "
              f"LoRA pack kernel), {len(calls)} calls into the autograd engine", flush=True)
        if counts != expect or calls:
            raise RuntimeError(f"{label}: launches {counts}, expected {expect}; autograd calls "
                               f"{len(calls)}")
        if not (np.isfinite(ktr.last_step_losses).all() and rel <= TRAIN_LOSS_RTOL):
            raise RuntimeError(f"{label}: epoch 0 losses from the xla twin by rel {rel}")
        ptr.model.load_state_dict(ktr.model.state_dict())
        got = ktr.render_views(test.poses[:1])
        counts.update(eval_fwd_pe=tk.fused_render_fwd_pe.launches,
                      eval_lora_pack=lora_pack.launches - counts["lora_pack"])
        want = ptr.render_views(test.poses[:1])
        chunks = -(-cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
        errs = {o: float(np.abs(g - w).max())
                for g, w, o in zip(got, want, ("rgb", "depth", "acc"))}
        print(f"  {label}: test view 0 against the xla twin's, the kernel trainer's weights: max "
              f"abs err " + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:.0e})" for k, v in errs.items())
              + f"; kernel 2 {counts['eval_fwd_pe']} launches for {chunks} chunks, "
              f"lora_pack {counts['eval_lora_pack']}", flush=True)
        if (not all(np.isfinite(g).all() for g in got) or any(v > TOL[k] for k, v in errs.items())
                or (counts["eval_fwd_pe"], counts["eval_lora_pack"]) != (chunks, packs)):
            raise RuntimeError(f"{label}: eval view {errs}, launches {counts}")
        out[label] = {**counts, "steps": steps, "ms_per_step": sec / steps * 1e3,
                      "loss_rel_to_xla": rel, "view_err": errs}
        del ktr, ptr
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
    from nerf_fewshot_tpu_torch.render.lora_pack import lora_pack, lora_pack_vjp
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features as spf
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
        spf.launches = 0
        psnr0 = ktr.evaluate()["psnr"]
        if tk.fused_render_fwd_pe.launches != n_chunks or spf.launches != n_chunks:
            raise RuntimeError(f"{name}: eval {tk.fused_render_fwd_pe.launches} kernel-2 and "
                               f"{spf.launches} sampler launches, {n_chunks} chunks")
        for e in epochs:
            ktr.phase_data(ktr._phase_index(e))
        boundary = cfg.optimizer.lora_only_after_epoch
        tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
        spf.launches = lora_pack.launches = lora_pack_vjp.launches = 0
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
        out["sampler_launches"] = spf.launches
        out["pack_launches"] = [lora_pack.launches, lora_pack_vjp.launches]
        print(f"  {name} launches: kernel 1 {out['launches']}, the sampler kernel "
              f"{out['sampler_launches']}, [lora_pack_fwd, lora_pack_vjp] "
              f"{out['pack_launches']} for {steps} steps", flush=True)
        lora_steps = steps if cfg.nerf.lora_rank else 0
        if out["launches"] != steps or out["sampler_launches"] != steps \
                or out["pack_launches"] != [lora_steps] * 2:
            raise RuntimeError(f"{name}: {out['launches']} kernel-1, {out['sampler_launches']} "
                               f"sampler and {out['pack_launches']} LoRA pack launches for "
                               f"{steps} steps")

        ptr.train_epoch(0)
        rel = np.abs(ptr.last_step_losses / losses0 - 1.0).max()
        print(f"  {name} epoch 0 vs the backend: xla twin: per-step max rel {rel:.2e} "
              f"(tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
        if not rel <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"{name}: epoch 0 kernel and plain trainers differ by rel {rel}")
        if spf.launches != out["sampler_launches"]:
            raise RuntimeError(f"{name}: the backend: xla twin launched the sampler kernel")

        tk.fused_render_fwd_pe.launches = 0
        spf.launches = 0
        after = ktr.evaluate()
        out.update(eval_launches=tk.fused_render_fwd_pe.launches, psnr=after["psnr"])
        out["sampler_launches"] += spf.launches
        print(f"  {name} evaluate: psnr {psnr0:.4f} dB at init, {after['psnr']:.4f} dB after "
              f"{steps} steps, ssim {after['ssim']:.5f}, {eval_ms(ktr)}, kernel 2 "
              f"{out['eval_launches']} and the sampler {spf.launches} launches for {n_chunks} "
              f"chunks", flush=True)
        if out["eval_launches"] != n_chunks or spf.launches != n_chunks:
            raise RuntimeError(f"{name}: eval launched kernel 2 {out['eval_launches']} and the "
                               f"sampler {spf.launches} times")
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
        out["sampler_ms"], out["sampler_plain_ms"] = sampler_ms_pair(ktr, pts, iters=10)
        print(f"  {name} at the trainer's shapes: kernel 1 {R}x{S} {out['train_ms']:.3f} ms, "
              f"kernel 2 {args[2].shape[0]}x{args[2].shape[1]} {out['fwd_ms']:.3f} ms, feature "
              f"sampling of {R * S} points x {SCRIPT_FD} channels {out['sampler_ms']:.4f} ms by "
              f"the kernel, {out['sampler_plain_ms']:.4f} ms by the plain sampler (CUDA events)",
              flush=True)
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


@contextmanager
def hf_home(path):
    """``$HF_HOME`` set to ``path`` and ``$NERF_DINOV2_WEIGHTS`` cleared inside
    the block, both restored after it."""
    saved = {k: os.environ.get(k) for k in ("HF_HOME", "NERF_DINOV2_WEIGHTS")}
    os.environ["HF_HOME"] = path
    os.environ.pop("NERF_DINOV2_WEIGHTS", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def printed(fn):
    """``(fn(), what it printed)``; the printed text is echoed."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def run_pretrained_dino(train, test, device, tk, tt, tmp):
    """``dino_nerf.yaml`` conditioned on a pretrained-format backbone: a
    seeded, complete ``facebook/dinov2-base`` state dict (HF key names, all
    12 layers) saved as ``pytorch_model.bin`` in an HF hub snapshot under
    ``tmp``; the extractor must print the load line, its maps must differ
    from the random-init maps by more than 1e-4 and equal the same
    extractor's maps on the CPU within CARD_CPU_ATOL; then
    ``run_dino_slice`` on those maps at PRETRAINED_EPOCHS (kernel 1 every
    step, kernel 2 every eval chunk, epoch 0 against a ``backend: xla``
    trainer, PSNR rising). Returns (the slice's numbers, the HF_HOME root
    of the weight file)."""
    from nerf_fewshot_tpu_torch.cli import _extract, _precompute_features
    from nerf_fewshot_tpu_torch.models.vit import load_state_dict_file
    from nerf_fewshot_tpu_torch.training.config import load_config

    cfg = load_config(os.path.join(ROOT, "experiments", "dino_nerf.yaml"))
    with hf_home(os.path.join(tmp, "no_weights")):
        random_maps = _precompute_features(cfg, train, device)
    root = os.path.join(tmp, "hf")
    snap = os.path.join(root, "hub", "models--facebook--dinov2-base", "snapshots", "seeded")
    os.makedirs(snap)
    path = os.path.join(snap, "pytorch_model.bin")
    t0 = time.perf_counter()
    torch.save(hf_dinov2_state_dict(np.random.default_rng(cfg.seed)), path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_tensors = len(load_state_dict_file(path))
    load_s = time.perf_counter() - t0
    print(f"  weight file: {n_tensors} tensors, {os.path.getsize(path) / 1e6:.1f} MB, written in "
          f"{write_s:.2f} s, read (load_state_dict_file) in {load_s:.3f} s", flush=True)
    with hf_home(root):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps, text = printed(lambda: _precompute_features(cfg, train, device))
        extract_s = time.perf_counter() - t0
        cpu_maps, cpu_text = printed(lambda: _extract(cfg, train, torch.device("cpu")))
    if LOAD_LINE + path not in text or LOAD_LINE + path not in cpu_text:
        raise RuntimeError("the extractor did not load the weight file")
    if maps.shape != (N_TRAIN_VIEWS, 9, 9, 64) or not np.isfinite(maps).all():
        raise RuntimeError(f"pretrained-format maps {maps.shape}")
    d_random = float(np.abs(maps - random_maps).max())
    d_cpu = float(np.abs(maps - cpu_maps).max())
    print(f"  maps {tuple(maps.shape)} in {extract_s:.2f} s (build, load and "
          f"{train.n_views} views): max abs difference from the random-init maps "
          f"{d_random:.3e} (must exceed 1e-4), card vs CPU {d_cpu:.3e} "
          f"(tol {CARD_CPU_ATOL:.0e})", flush=True)
    if not d_random > 1e-4:
        raise RuntimeError("the pretrained-format maps equal the random-init ones")
    if not d_cpu <= CARD_CPU_ATOL:
        raise RuntimeError(f"pretrained-format maps: card vs CPU {d_cpu}")
    out = run_dino_slice("dino_nerf.yaml", train, test, device, tk, tt, feats=maps,
                         epochs=PRETRAINED_EPOCHS, label=PRETRAINED_LABEL)
    out.update(load_s=load_s, map_err_cpu=d_cpu)
    return out, root


DUMP_CONFIG = """experiment:
  name: "dino_lora_dump"
data:
  resolution: 128
  num_views: {views}
model:
  use_dino: true
  dino_model_type: "dino_lora"
output:
  save_dir: "{save_dir}"
"""


def run_dumper(device, tmp, weights_root):
    """``cli extract-features`` in process on a ``dino_lora`` config
    (DUMP_VIEWS views at 128x128, ``--synthetic``) with the weight file
    under ``weights_root``: the load line, tokens (V, 256, 768), finite,
    equal to the CPU port's dump within CARD_CPU_ATOL and unlike the
    random-init dump; the ms per view of the extractor on the card
    (preprocessing and ViT apart) and, as a report, view 0 of both dumps
    against the same model in float64 on the card. Returns a dict of the
    numbers."""
    from nerf_fewshot_tpu_torch import cli
    from nerf_fewshot_tpu_torch.models.dino import build_feature_extractor
    from nerf_fewshot_tpu_torch.models.vit import preprocess_dinov2_processor_input
    from nerf_fewshot_tpu_torch.training.config import load_config

    path = os.path.join(tmp, "dino_lora_dump.yaml")
    with open(path, "w") as f:
        f.write(DUMP_CONFIG.format(views=DUMP_VIEWS, save_dir=os.path.join(tmp, "dump")))

    def dump(where, home, tag):
        out = os.path.join(tmp, f"{tag}.npz")
        with hf_home(home):
            t0 = time.perf_counter()
            _, text = printed(lambda: cli.main(["extract-features", "--config", path,
                                                "--synthetic", "--device", where,
                                                "--output", out]))
            sec = time.perf_counter() - t0
        return np.load(out)["features"], text, sec

    card, text, card_s = dump("cuda", weights_root, "card")
    cpu, cpu_text, cpu_s = dump("cpu", weights_root, "cpu")
    rand, rand_text, _ = dump("cuda", os.path.join(tmp, "no_weights"), "random")
    if LOAD_LINE not in text or LOAD_LINE not in cpu_text or LOAD_LINE in rand_text:
        raise RuntimeError("the dumper's weight discovery misbehaved")
    if card.shape != (DUMP_VIEWS, 256, 768) or not np.isfinite(card).all():
        raise RuntimeError(f"dumped tokens {card.shape}")
    d_cpu = float(np.abs(card - cpu).max())
    d_random = float(np.abs(card - rand).max())

    cfg = load_config(path)
    with hf_home(weights_root):
        model, text = printed(lambda: build_feature_extractor(cfg.dino, cfg.data.resolution,
                                                              seed=cfg.seed, device=device))
    if LOAD_LINE not in text:
        raise RuntimeError("the timed extractor did not load the weight file")
    train, _ = cli._load_datasets(cfg, True, device)
    images = [torch.as_tensor(np.asarray(im, np.float32), device=device)
              for im in train.white_composited()]
    pre_ms, vit_ms = [], []
    with torch.no_grad():
        model(images[0])
        for im in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = preprocess_dinov2_processor_input(im)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.backbone(x)
            torch.cuda.synchronize()
            pre_ms.append((t1 - t0) * 1e3)
            vit_ms.append((time.perf_counter() - t1) * 1e3)
        # a report: view 0's tokens against the same model in float64 on the card
        exact = model.double().backbone(preprocess_dinov2_processor_input(images[0]).double())
        exact = exact[1:].cpu().numpy()
    ms = np.add(pre_ms, vit_ms)
    print(f"  cli extract-features dino_lora: tokens {tuple(card.shape)}, the call {card_s:.2f} s "
          f"on the card, {cpu_s:.2f} s on the CPU; card vs CPU max abs {d_cpu:.3e} (tol "
          f"{CARD_CPU_ATOL:.0e}), vs the random-init dump {d_random:.3e} (must exceed 1e-4); "
          f"view 0 against float64 on the card: card {np.abs(card[0] - exact).max():.3e}, CPU "
          f"{np.abs(cpu[0] - exact).max():.3e}; extractor {np.mean(ms):.3f} ms per view on the "
          f"card (preprocessing {np.mean(pre_ms):.3f}, ViT-B/14 {np.mean(vit_ms):.3f}; "
          f"{len(ms)} views: {', '.join(f'{m:.3f}' for m in ms)})", flush=True)
    if not d_cpu <= CARD_CPU_ATOL:
        raise RuntimeError(f"dumped tokens: card vs CPU {d_cpu}")
    if not d_random > 1e-4:
        raise RuntimeError("the dump with the weight file equals the random-init dump")
    return {"ms_per_view": float(np.mean(ms)), "err_cpu": d_cpu, "call_s": card_s}


def run_gradient_gate(tt):
    """``render/verify.py``'s ``kernel_gradient_check`` at sigma_bias 0.1
    and 5.0: both ``ok``. Returns kernel 1's launches."""
    from nerf_fewshot_tpu_torch.render.verify import kernel_gradient_check

    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    for sigma_bias in (0.1, 5.0):
        r = kernel_gradient_check(sigma_bias=sigma_bias)
        print(f"  kernel_gradient_check(sigma_bias={sigma_bias}): ok {r['ok']}, grad_rel_err "
              f"{r['grad_rel_err']:.3e}, loss_rel_err {r['loss_rel_err']:.3e}, backend "
              f"{r['backend']}", flush=True)
        if not r["ok"]:
            raise RuntimeError(f"kernel_gradient_check(sigma_bias={sigma_bias}): {r}")
    launches = tt.fused_train_objective.launches["train_pe"]
    if launches != 2:
        raise RuntimeError(f"the gate launched kernel 1 {launches} times")
    return launches


def run_sigma_noise(train, test, device, tk, tt):
    """``baseline.yaml`` with ``strict_reference_behavior: false`` and
    ``rendering.noise_std: 1.0`` at NOISE_EPOCHS: the plain path with the
    JAX trainer's reason, no kernel launched, finite losses; ``backend:
    fused`` raises."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    raw = {**BASELINE_CONFIG, "strict_reference_behavior": False,
           "rendering": {**BASELINE_CONFIG["rendering"], "noise_std": 1.0}}
    tr = Trainer(config_from_dict(raw), train, test, device=device)
    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    tk.fused_render_fwd_pe.launches = tk.fused_render_fwd.launches = 0
    tk.fused_render_bwd.launches = 0
    for e in NOISE_EPOCHS:
        t0 = time.perf_counter()
        loss = tr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"  noisy epoch {e}: loss {loss:.6f}, {len(tr.last_step_losses)} steps on the "
              f"{tr.kernel_path} path in {sec:.3f} s", flush=True)
        if not np.isfinite(tr.last_step_losses).all():
            raise RuntimeError(f"noisy epoch {e}: non-finite losses")
    launches = (sum(tt.fused_train_objective.launches.values()) + tk.fused_render_fwd_pe.launches
                + tk.fused_render_fwd.launches + tk.fused_render_bwd.launches)
    print(f"  kernel_path {tr.kernel_path!r}, reason {tr.kernel_path_reason!r}, "
          f"{launches} kernel launches", flush=True)
    if tr.kernel_path != "plain" or tr.kernel_path_reason != NOISE_REASON or launches:
        raise RuntimeError("sigma noise did not train on the plain path alone")
    fused = Trainer(config_from_dict({**raw, "rendering": {**raw["rendering"],
                                                           "backend": "fused"}}),
                    train, test, device=device)
    try:
        fused.train_epoch(0)
    except ValueError as e:
        print(f"  backend: fused raises: {e}", flush=True)
    else:
        raise RuntimeError("backend: fused trained with sigma noise")


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


def run_data_parallel(device, tk, tmp, smi):
    """World 1 on NCCL as CUDA graph replays (each replay: kernel 1, the
    Adam kernel and the all-reduce of the gradients and the loss, once)
    against the no-mesh trainer and an eager one-rank mesh trainer
    (``Trainer(_eager_step=True)``), bit for bit in per-step losses,
    parameters and Adam moments; its eval (kernel 2 once per chunk); no
    synchronization in a graphed mesh epoch; ms per step of the three and
    the all-reduce's share of a graphed step; world 2 on Gloo (eager, its
    reason recorded) against world 1; then ``multihost_train_smoke
    --kernels`` as two Gloo processes on the card and ``cli train
    --multihost`` on ``dino_nerf.yaml`` at world 1 (NCCL, read from the
    environment); ``lora_nerf_trunk.yaml`` at world 1 (``run_data_parallel_lora``).
    Returns the graphed world 1's launches of kernels 1 and 2 and the Adam
    kernel, the Gloo ranks' of kernel 1, the sampler's and the LoRA pack
    kernels'."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.tools import dp_runs
    from nerf_fewshot_tpu_torch.training.optim import AdamKernel

    plain = dp_runs.dp_run(dp_runs.dp_trainer(BASELINE_CONFIG, device=device), DP_EPOCHS)
    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=device)
    try:
        mesh = pmesh.make_mesh(device)
        trainer = dp_runs.dp_trainer(BASELINE_CONFIG, mesh, with_test=True)
        adam0, reduced0 = AdamKernel.launches, pmesh.all_reduce_sum_.launches
        one = dp_runs.dp_run(trainer, DP_EPOCHS)
        adam_launches = AdamKernel.launches - adam0
        reduced = pmesh.all_reduce_sum_.launches - reduced0
        eager = dp_runs.dp_run(dp_runs.dp_trainer(BASELINE_CONFIG, mesh, eager=True), DP_EPOCHS)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        one["collective_ms"] = dp_runs.collective_ms(mesh, n_params)
        tk.fused_render_fwd_pe.launches = 0
        metrics = trainer.evaluate()
        eval_launches = tk.fused_render_fwd_pe.launches
        no_sync_run(f"world 1 epoch {DP_EPOCHS[-1]}'s steps (NCCL, graph replays)",
                    lambda: trainer.epoch_steps(DP_EPOCHS[-1]))
    finally:
        dist.destroy_process_group()
    n_steps = [len(s) for s in one["steps"]]
    print(f"  world 1 ({mesh.backend}, {mesh.device}): step modes {one['step_mode']} / "
          f"{eager['step_mode']} ({eager['step_mode_reason']}); {n_steps} steps at epochs "
          f"{DP_EPOCHS}, kernel 1 {one['launches']} launches on {sorted(set(one['rays']))} rays, "
          f"the Adam kernel {adam_launches}, the all-reduce {reduced}; one replay "
          f"{one['launches_per_replay']}; eval psnr {metrics['psnr']:.4f} dB, kernel 2 "
          f"{eval_launches} launches", flush=True)
    if (one["step_mode"], one["step_mode_reason"]) != ("graph", None) \
            or eager["step_mode"] != "eager":
        raise RuntimeError(f"world 1 step modes: {one['step_mode']} "
                           f"({one['step_mode_reason']}), {eager['step_mode']}")
    for label, other in (("the no-mesh trainer", plain), ("the eager mesh step", eager)):
        differs = dp_runs.run_difference(one, other)
        if differs is not None:
            raise RuntimeError(f"world 1 graph: {differs} differ from {label}'s")
    print("  world 1 graph against no mesh and against the eager mesh step: per-step losses, "
          "parameters and Adam moments bit-equal", flush=True)
    n_chunks = -(-N_TEST_VIEWS * trainer.H * trainer.W // trainer.cfg.rendering.chunk_size)
    per = one["launches_per_replay"] or {}
    if one["launches"] != sum(n_steps) or eval_launches != n_chunks \
            or adam_launches != sum(n_steps) or reduced != sum(n_steps) \
            or {k: per.get(k) for k in ("train_pe", "adam", "allreduce")} != \
            {"train_pe": 1, "adam": 1, "allreduce": 1} \
            or any(v for k, v in per.items() if k not in ("train_pe", "adam", "allreduce")):
        raise RuntimeError(f"world 1: kernel 1 {one['launches']}, Adam {adam_launches}, "
                           f"all-reduce {reduced} launches for {sum(n_steps)} steps, kernel 2 "
                           f"{eval_launches} for {n_chunks} chunks; a replay {per}")
    del trainer

    t0 = time.perf_counter()
    two = pmesh.launch(dp_runs.dp_rank, [device, device], (BASELINE_CONFIG, DP_EPOCHS),
                       backend="gloo", timeout_s=600)
    sec = time.perf_counter() - t0
    for r in (1, 0):
        for e, g, w in zip(DP_EPOCHS, two[r]["steps"], two[0]["steps"]):
            if not np.array_equal(g, w):
                raise RuntimeError(f"world 2: rank {r}'s losses of epoch {e} differ from rank 0's")
    if any(not np.array_equal(two[1]["params"][k], v) for k, v in two[0]["params"].items()):
        raise RuntimeError("world 2: the ranks' parameters differ")
    reason = two[0]["step_mode_reason"] or ""
    if any(t["step_mode"] != "eager" for t in two) or not reason.startswith("a gloo mesh"):
        raise RuntimeError(f"world 2 gloo: step modes {[t['step_mode'] for t in two]} "
                           f"({reason})")
    rel = np.abs(two[0]["steps"][0] / one["steps"][0] - 1).max()
    print(f"  world 2 (gloo, two ranks on {device}, {sec:.1f} s with start-up): eager ({reason}); "
          f"ranks bit-equal in losses and parameters; epoch 0 per step max rel {rel:.3e} to "
          f"world 1 (tol {DP_LOSS_RTOL:.0e}); kernel 1 {[t['launches'] for t in two]} launches "
          f"per rank on {sorted(set(two[0]['rays']))} rays", flush=True)
    if not rel <= DP_LOSS_RTOL:
        raise RuntimeError(f"world 2 epoch 0: per-step losses differ from world 1 by rel {rel}")
    half = sorted({r // 2 for r in eager["rays"]})
    for t in two:
        if t["launches"] != sum(n_steps) or sorted(set(t["rays"])) != half:
            raise RuntimeError(f"world 2: kernel 1 {t['launches']} launches on "
                               f"{sorted(set(t['rays']))} rays; want {sum(n_steps)} on {half}")
    at = {e: i for i, e in enumerate(DP_EPOCHS)}
    for e in DP_EPOCHS[-2:]:
        what = "the phase's capture" if one["captured"][at[e]] else "replays only"
        print(f"  ms per step at epoch {e} ({what}; {n_steps[at[e]]} steps): no mesh "
              f"{plain['ms_per_step'][at[e]]:.3f}, world 1 nccl graph "
              f"{one['ms_per_step'][at[e]]:.3f}, world 1 nccl eager "
              f"{eager['ms_per_step'][at[e]]:.3f}, world 2 gloo "
              f"{[round(t['ms_per_step'][at[e]], 3) for t in two]} per rank (two ranks share the "
              f"card; gloo's numbers do not represent nccl's); {smi}", flush=True)
    last = DP_EPOCHS[-1]
    ar = one["collective_ms"]
    if ar["graph"] is not None:
        raise AssertionError("world 1: collective_ms timed a graph, which holds no device work")
    # at world 1 the in-place all-reduce enqueues no device work, so a graph
    # of it is empty and its per-replay count is the capture's Python call:
    # the captured collective with device work runs in tools/dp_runs.py only
    print(f"  the mesh step's all-reduce of the loss and {n_params} gradients ({smi}): "
          f"{ar['eager']:.4f} ms eager, {ar['eager'] / eager['ms_per_step'][-1]:.1%} of an eager "
          f"world 1 step at epoch {last} ({eager['ms_per_step'][-1]:.3f} ms); in a graph at "
          f"world 1 it is no device work (one rank: nothing to sum), so no graph time is given "
          f"and the 'allreduce' per replay counts the call the capture recorded; a captured "
          f"collective that moves data runs only under tools/dp_runs.py on several cards",
          flush=True)
    ar = two[0]["collective_ms"]
    print(f"  world 2 gloo rank 0: the all-reduce {ar['eager']:.3f} ms, "
          f"{ar['eager'] / two[0]['ms_per_step'][-1]:.1%} of a step", flush=True)

    sampler = run_data_parallel_dino(device)
    lora_dp = run_data_parallel_lora(device)

    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    address = f"localhost:{pmesh.free_port()}"
    harness = [subprocess.Popen(
        [sys.executable, "-m", "nerf_fewshot_tpu_torch.parallel.multihost_train_smoke",
         "--coordinator", address, "--num-processes", "2", "--process-id", str(i),
         "--device", "cuda", "--backend", "gloo", "--kernels"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    cli_env = {**env, "MASTER_ADDR": "localhost", "MASTER_PORT": str(pmesh.free_port()),
               "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    cli = subprocess.Popen(
        [sys.executable, "-m", "nerf_fewshot_tpu_torch.cli", "train", "--config",
         os.path.join(ROOT, "experiments", "dino_nerf.yaml"), "--synthetic", "--epochs", "2",
         "--multihost"], cwd=tmp, env=cli_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = [*harness, cli]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{p.args[2]} exited {p.returncode}:\n{out}\n{err or ''}")
    lines = [re.search(r"devices=2 kernel=fused losses=[0-9.,]+", out) for out, _ in outs[:2]]
    if not all(lines) or lines[0].group(0) != lines[1].group(0):
        raise RuntimeError(f"multihost_train_smoke: {[o for o, _ in outs[:2]]}")
    print(f"  multihost_train_smoke --kernels, two gloo processes on the card: exit 0, "
          f"{lines[0].group(0)} on both", flush=True)
    out = outs[2][0]
    mesh_line = "[mesh] data-parallel over 1 devices across 1 processes (nccl)"
    summary = json.loads(out.strip().splitlines()[-1])
    if mesh_line not in out or summary["final_metrics"].get("kernel_path") != "kernel":
        raise RuntimeError(f"cli train --multihost: {out}")
    if not os.path.exists(os.path.join(tmp, "results", "dino_nerf_lego", "final.ckpt")):
        raise RuntimeError("cli train --multihost wrote no final.ckpt")
    print(f"  cli train dino_nerf.yaml --synthetic --epochs 2 --multihost (world 1 from the "
          f"environment): exit 0, {mesh_line!r}, kernel path, final.ckpt", flush=True)
    return (one["launches"], eval_launches, adam_launches, [t["launches"] for t in two], sampler,
            lora_dp)


def run_data_parallel_dino(device):
    """``dino_nerf.yaml`` on seeded maps at DP_DINO_EPOCHS with no mesh, on a
    one-rank NCCL mesh (graph replays) and on two Gloo ranks on the card
    (eager), each rank sampling its shard's features through the sampler
    kernel: world 1 bit-equal to no mesh in losses, parameters and Adam
    moments, the ranks bit-equal, world 2 within DP_LOSS_RTOL of world 1;
    the sampler and kernel 1 once per step on every rank, or raise. Returns
    the sampler's launches by run."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.tools import dp_runs
    from nerf_fewshot_tpu_torch.training.config import load_config

    raw = load_config(os.path.join(ROOT, "experiments", "dino_nerf.yaml")).raw
    maps = np.random.default_rng(13).standard_normal((N_TRAIN_VIEWS, 9, 9, 64)).astype(np.float32)
    plain = dp_runs.dp_run(dp_runs.dp_trainer(raw, device=device, dino_features=maps),
                           DP_DINO_EPOCHS)
    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=device)
    try:
        one = dp_runs.dp_run(dp_runs.dp_trainer(raw, pmesh.make_mesh(device),
                                                dino_features=maps), DP_DINO_EPOCHS)
    finally:
        dist.destroy_process_group()
    two = pmesh.launch(dp_runs.dp_rank, [device, device], (raw, DP_DINO_EPOCHS, maps),
                       backend="gloo", timeout_s=600)
    steps = sum(len(s) for s in plain["steps"])
    differs = dp_runs.run_difference(one, plain)
    if differs is not None:
        raise RuntimeError(f"dino_nerf world 1: {differs} differ from no mesh")
    if one["step_mode"] != "graph" or any(t["step_mode"] != "eager" for t in two):
        raise RuntimeError(f"dino_nerf step modes: world 1 {one['step_mode']}, world 2 "
                           f"{[t['step_mode'] for t in two]}")
    if any(not np.array_equal(g, w) for g, w in zip(two[0]["steps"], two[1]["steps"])):
        raise RuntimeError("dino_nerf world 2: the ranks' losses differ")
    rel = max(np.abs(g / w - 1).max() for g, w in zip(two[0]["steps"], one["steps"]))
    launches = {"no mesh": plain["sampler_launches"], "world 1 nccl": one["sampler_launches"],
                "world 2 gloo per rank": [t["sampler_launches"] for t in two]}
    print(f"  dino_nerf.yaml (seeded 9x9x64 maps) at epochs {DP_DINO_EPOCHS}: world 1 (graph "
          f"replays) bit-equal to no mesh in losses, parameters and Adam moments; world 2 "
          f"(eager) ranks bit-equal, max rel {rel:.3e} to world 1 (tol "
          f"{DP_LOSS_RTOL:.0e}); {steps} steps, the sampler kernel's launches {launches}, kernel "
          f"1's {[plain['launches'], one['launches']] + [t['launches'] for t in two]}",
          flush=True)
    if not rel <= DP_LOSS_RTOL:
        raise RuntimeError(f"dino_nerf world 2: per-step losses off world 1 by rel {rel}")
    counts = [plain["sampler_launches"], one["sampler_launches"], plain["launches"],
              one["launches"]] + [t[k] for t in two for k in ("sampler_launches", "launches")]
    if counts != [steps] * len(counts):
        raise RuntimeError(f"dino_nerf data parallel: launches {counts} for {steps} steps")
    return launches


def run_data_parallel_lora(device):
    """``lora_nerf_trunk.yaml`` (``sigma_bias: 0.1``) on seeded 9x9x64 maps at
    DP_DINO_EPOCHS with no mesh and on a one-rank NCCL mesh, as graph
    replays and through the eager mesh step: both bit-equal to no mesh in
    losses, parameters and Adam moments, every step launching kernel 1 and
    the two LoRA pack kernels once (a replay each once), or raise. Returns
    the LoRA pack kernels' launches by run."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.tools import dp_runs

    raw = lora_trunk_configs()[1].raw
    maps = np.random.default_rng(14).standard_normal((N_TRAIN_VIEWS, 9, 9, 64)).astype(np.float32)
    plain = dp_runs.dp_run(dp_runs.dp_trainer(raw, device=device, dino_features=maps),
                           DP_DINO_EPOCHS)
    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=device)
    try:
        mesh = pmesh.make_mesh(device)
        runs = {mode: dp_runs.dp_run(dp_runs.dp_trainer(raw, mesh, dino_features=maps,
                                                        eager=mode == "eager"), DP_DINO_EPOCHS)
                for mode in ("graph", "eager")}
    finally:
        pmesh.shutdown()
    steps = sum(len(s) for s in plain["steps"])
    for mode, run in runs.items():
        differs = dp_runs.run_difference(run, plain)
        if differs is not None or run["step_mode"] != mode:
            raise RuntimeError(f"lora trunk world 1 {mode} ({run['step_mode']}): {differs} "
                               f"differ from no mesh")
    per = runs["graph"]["launches_per_replay"] or {}
    counts = {"no mesh": plain["lora_launches"],
              **{f"world 1 nccl {m}": r["lora_launches"] for m, r in runs.items()}}
    print(f"  lora_nerf_trunk.yaml (seeded 9x9x64 maps) at epochs {DP_DINO_EPOCHS}: world 1 "
          f"graph replays and eager mesh steps bit-equal to no mesh in losses, parameters and "
          f"Adam moments; {steps} steps, [lora_pack_fwd, lora_pack_vjp] launches {counts}, "
          f"kernel 1's {[plain['launches']] + [r['launches'] for r in runs.values()]}; one "
          f"replay {per}", flush=True)
    if any(c != [steps, steps] for c in counts.values()) \
            or any(r["launches"] != steps for r in (plain, *runs.values())) \
            or [per.get(k) for k in ("train_pe", "lora_pack", "lora_pack_vjp", "allreduce")] \
            != [1, 1, 1, 1]:
        raise RuntimeError(f"lora trunk data parallel: launches {counts} for {steps} steps, "
                           f"a replay {per}")
    return counts


# The kernels (route_bits.py call-name prefixes) whose sums this tree
# orders differently from its parent's build by design; the parent check
# reports them instead of gating them bit for bit. None: trunk widths 384
# and 512 are new builds, and widths 128 and 256 keep the parent's.
REORDERED_VS_PARENT = ()
# the configs tools/train_runs.py times against the parent beside the baseline
TRAIN_RUNS_CONFIGS = ("baseline", "dino_nerf", "lora_trunk", "script_lora")


def run_parent_bits():
    """The five kernels at every route against a parent checkout's build,
    when ``$NERF_PARENT_CHECKOUT`` names one: ``tools/route_bits.py`` on
    both trees (each in its own process; the change's kernels on the
    inputs the parent's glue made), bit-equal but for
    ``REORDERED_VS_PARENT``, whose relative difference is printed; then
    kernels 1, 5 and 3 timed in alternating pairs, parent / change / change
    / parent (``tools/train_times.py``), the pairs and means printed; the
    LoRA pack kernels likewise (``tools/lora_pack_times.py``: outputs
    bit-equal to the parent's at every shape both take, device ms); then
    the main-path trainer (``baseline.yaml`` over the smoke's epochs, 670
    steps) in the same order (``tools/train_runs.py``, each run in its own
    process): every run's per-step losses, final parameters and eval view
    bit-equal to the parent's first, and the pairs' ms per step (also of
    ``TRAIN_RUNS_CONFIGS``), eval ms per view and traced epochs printed. A
    checkout of the repo alone has no parent, and the phase says so."""
    parent = os.environ.get("NERF_PARENT_CHECKOUT")
    if not parent:
        print("  NERF_PARENT_CHECKOUT is not set: the routes and the kernel times are not "
              "compared with a parent build in this run (nerf_fewshot_tpu_torch/tools/"
              "route_bits.py, train_times.py)", flush=True)
        return
    tools = os.path.join(ROOT, "nerf_fewshot_tpu_torch", "tools")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bits_")
    roots = (("parent", os.path.abspath(parent)), ("change", ROOT))
    try:
        files = []
        for tag, root in roots:  # the change's kernels on the parent's inputs
            files.append(os.path.join(tmp, f"{tag}.pt"))
            subprocess.run([sys.executable, os.path.join(tools, "route_bits.py"), "--root", root,
                            "--out", files[-1], *(["--inputs", files[0]] if tag == "change"
                                                  else [])], check=True, timeout=900)
        subprocess.run([sys.executable, os.path.join(tools, "route_bits.py"), "--compare",
                        *files, "--reordered", *REORDERED_VS_PARENT], check=True, timeout=300)
        times = os.path.join(tmp, "times.jsonl")
        for tag, root in (*roots, *roots[::-1]):
            subprocess.run([sys.executable, os.path.join(tools, "train_times.py"), "--root",
                            root, "--tag", tag, "--out", times], check=True, timeout=900,
                           stdout=subprocess.DEVNULL)
        subprocess.run([sys.executable, os.path.join(tools, "train_times.py"), "--summarize",
                        times, "--base", "parent", "--change", "change"], check=True, timeout=60)
        # the LoRA pack kernels, A B B A: outputs bit-equal, device ms a call
        packs = os.path.join(tmp, "lora_pack.jsonl")
        for tag, root in (*roots, *roots[::-1]):
            subprocess.run([sys.executable, os.path.join(tools, "lora_pack_times.py"), "--root",
                            root, "--tag", tag, "--out", packs], check=True, timeout=600,
                           stdout=subprocess.DEVNULL)
        subprocess.run([sys.executable, os.path.join(tools, "lora_pack_times.py"), "--summarize",
                        packs, "--base", "parent", "--change", "change"], check=True, timeout=60)
        # the main-path trainer over the smoke's epochs, A B B A: bit-equal
        # losses, parameters and eval view, then the step and eval times
        runs = os.path.join(tmp, "runs.jsonl")
        bits = []
        for i, (tag, root) in enumerate((*roots, *roots[::-1])):
            bits.append(os.path.join(tmp, f"{tag}{i}.pt"))
            subprocess.run([sys.executable, os.path.join(tools, "train_runs.py"), "--root", root,
                            "--tag", tag, "--out", runs, "--bits", bits[-1], "--configs",
                            *TRAIN_RUNS_CONFIGS], check=True, timeout=900,
                           stdout=subprocess.DEVNULL)
        for other in bits[1:]:
            subprocess.run([sys.executable, os.path.join(tools, "train_runs.py"),
                            "--compare-bits", bits[0], other], check=True, timeout=120)
        subprocess.run([sys.executable, os.path.join(tools, "train_runs.py"), "--summarize",
                        runs, "--base", "parent", "--change", "change"], check=True, timeout=60)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def route_bounds(flops, nbytes, compute_dtype):
    """``(bound_ms, bound_by, rate)`` of a kernel at a precision route."""
    rate, label = ROUTE_RATE[compute_dtype]
    ops_s, bytes_s = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes", label


def fwd_pe_case(width, a, use_feats):
    """Kernel 2 on ``a`` (``random_fwd_pe_args``) as a ``run_route_kernels``
    case: ``(kernel, width, run(cd), plain(cd), f64(cd), flops, nbytes)``;
    ``run`` and ``plain`` return flat tuples."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.tools.f64_cases import to_f64

    x32 = lambda: tk._pe_input(a[0], a[1] if use_feats else None, a[4], a[5], a[6][0].shape[0])
    return ("fwd_pe", width,
            lambda cd: tk.fused_render_fwd_pe(*a, compute_dtype=cd, use_feats=use_feats),
            lambda cd: tk.fused_render_fwd_pe_reference(*a, compute_dtype=cd, use_feats=use_feats),
            lambda cd: tk.fused_render_reference(*to_f64((x32(), *a[2:4], a[6])), compute_dtype=cd),
            *fwd_pe_cost(a, use_feats))


def fwd_x_case(width, a, x_dim):
    """Kernel 4 on ``a`` (``random_render_args``), as ``fwd_pe_case``."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.tools.f64_cases import to_f64

    return ("fwd", width, lambda cd: tk.fused_render_fwd(*a, compute_dtype=cd),
            lambda cd: tk.fused_render_reference(*a, compute_dtype=cd),
            lambda cd: tk.fused_render_reference(*to_f64(a), compute_dtype=cd),
            *render_cost(a, x_dim, backward=False))


def render_bwd_case(width, a, cot, x_dim):
    """Kernel 3 on ``a`` and the cotangents ``cot``, as ``fwd_pe_case``."""
    from nerf_fewshot_tpu_torch.render import kernels as tk
    from nerf_fewshot_tpu_torch.tools.f64_cases import to_f64

    return ("render_bwd", width,
            lambda cd: flat_objective(tk.fused_render_bwd(*a, *cot, compute_dtype=cd)),
            lambda cd: flat_objective(tk.fused_render_bwd_reference(*a, *cot, compute_dtype=cd)),
            lambda cd: flat_objective(tk.fused_render_bwd_reference(*to_f64(a), *to_f64(cot),
                                                                    compute_dtype=cd)),
            *render_cost(a, x_dim, backward=True))


def train_case(width, a, o, x_dim=None):
    """Kernel 1 (``o["inline_pe"]``) or 5 on ``(a, o)``
    (``random_train_args``), as ``fwd_pe_case``."""
    from nerf_fewshot_tpu_torch.render import train_kernel as tt
    from nerf_fewshot_tpu_torch.tools.f64_cases import objective_f64

    with_cd = lambda cd: {**o, "compute_dtype": cd}
    return ("train_pe" if o["inline_pe"] else "train_x", width,
            lambda cd: flat_objective(tt.fused_train_objective(*a, **with_cd(cd))),
            lambda cd: flat_objective(tt.fused_train_objective_reference(*a, **with_cd(cd))),
            lambda cd: flat_objective(objective_f64(a, with_cd(cd))),
            *train_cost(a, o, x_dim))


def cap_case(kernel, label, shape, device, seed=19):
    """One kernel at a shape past a cap the kernels once had (``CAP_CASES``:
    ``shape`` = (R, S, H, L, features)) on random inputs from ``seed``: the
    inline-PE input padded to a multiple of 16 (90 PE columns + the
    features), the x encoded to a multiple of 128; the objective with a
    white background, an eighth of the rays masked, the w^2 and depth
    terms. A ``run_route_kernels`` case."""
    from nerf_fewshot_tpu_torch.render import kernels as tk

    R, S, H, L, fd = shape
    rng = np.random.default_rng(seed)
    if kernel == "fwd_pe":
        a = random_fwd_pe_args(rng, R, S, H, L, fd, device, d_pad=tk.pe_width(90 + fd))
        return fwd_pe_case(label, a, fd > 0)
    if kernel in ("fwd", "render_bwd"):
        a, x_dim = random_render_args(rng, R, S, H, L, device, feat_dim=fd)
        if kernel == "fwd":
            return fwd_x_case(label, a, x_dim)
        return render_bwd_case(label, a, random_cotangents(rng, R, S, device), x_dim)
    inline = kernel == "train_pe"
    a, o = random_train_args(rng, R, S, H, L, device, feat_dim=fd, white_bkgd=True,
                             ragged=R // 8, reg_weight=0.01, depth_weight=0.1, inline_pe=inline)
    return train_case(label, a, o, x_dim=None if inline else 90 + fd)


def route_cases(trainer, test, device, label="d96", dino=True):
    """The five kernels' inputs at the main path's shapes for the trainer's
    widths and weights (a 2048x64 eval chunk for kernels 2 and 4, D 96 /
    x 128; the phase-2 batch of 512x64 for kernels 1, 5 and 3), named
    ``label``, and, with ``dino``, at the DINO width (pos_freq 12 with 64
    features: D 176 inline, a 256-wide x, 8x256, random inputs), each as
    ``(kernel, width, run(cd), plain(cd), f64(cd), flops, nbytes)``; ``run``
    and ``plain`` return flat tuples (outputs, or dx / the loss and the
    packed gradients)."""
    rng = np.random.default_rng(trainer.cfg.seed)
    last = len(trainer.cfg.phases) - 1
    bw, cot = main_path_render_bwd_args(trainer, device)
    cases = [fwd_pe_case(label, main_path_fwd_pe_args(trainer, test.poses[0], device), False),
             fwd_x_case(label, main_path_fwd_x_args(trainer, test.poses[0], device), 90),
             render_bwd_case(label, bw, cot, 90),
             train_case(label, *main_path_train_args(trainer, last, device)),
             train_case(label, *main_path_train_args(trainer, last, device, inline_pe=False),
                        x_dim=90)]
    if not dino:
        return cases
    cases.append(fwd_pe_case("d176", random_fwd_pe_args(rng, 1024, 64, 256, 8, 64, device,
                                                        pos_freq=12, d_pad=176), True))
    a, x_dim = random_render_args(rng, 2048, 64, 256, 8, device, feat_dim=64, pos_freq=12)
    cases.append(fwd_x_case("d176", a, x_dim))
    a, x_dim = random_render_args(rng, 512, 64, 256, 8, device, feat_dim=64, pos_freq=12)
    cases.append(render_bwd_case("d176", a, random_cotangents(rng, 512, 64, device), x_dim))
    cases.append(train_case("d176", *random_train_args(rng, 512, 64, 256, 8, device, feat_dim=64,
                                                       pos_freq=12)))
    a, o = random_train_args(rng, 512, 64, 256, 8, device, feat_dim=64, pos_freq=12,
                             inline_pe=False)
    cases.append(train_case("d176", a, o, x_dim=6 + 72 + 24 + 64))
    return cases


def run_route_kernels(cases, routes=ROUTES, launch_widths=("d96",)):
    """Every kernel of ``cases`` (``route_cases``) at every route of
    ``routes`` against its plain version at the same route (TF32 off): two
    calls bit for bit; ``float32`` the §2 gates (TOL, gradient vectors rel
    TRAIN_GRAD_TOL), the other routes ROUTE_TOL and no further from a
    float64 run at the route than F64_FACTOR times the plain version's
    distance, bfloat16 apart from the float32 route; the float64 distances
    printed at every route; CUDA-event times and the bound at the route's
    rate (3xTF32 at 495 TFLOP/s for ``float32``); kernels 1 and 3 at the
    widths of ``launch_widths`` also the device time of each grid launch.
    Returns ``{(kernel, width, route): numbers}``."""
    rows = {}
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts if t is not None])
    rel = lambda a, b: ((flat(a) - flat(b)).norm() / flat(b).norm()).item()
    for kernel, width, run, plain, f64, flops, nbytes in cases:
        forward = kernel in ("fwd_pe", "fwd")
        for cd in routes:
            label = f"{kernel} {width} {cd}"
            got, again = run(cd), run(cd)
            torch.cuda.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(got, again) if p is not None):
                raise RuntimeError(f"{label}: two calls on the same inputs differ")
            if not all(torch.isfinite(t).all() for t in got if t is not None):
                raise RuntimeError(f"{label}: non-finite output")
            want, exact = plain(cd), f64(cd)
            tol = {**TOL, "grad": TRAIN_GRAD_TOL} if cd == "float32" else ROUTE_TOL[cd]
            max_err = (flat(got) - flat(want)).abs().max().item()
            if forward:
                errs = {o: (g - w).abs().max().item()
                        for g, w, o in zip(got, want, ("rgb", "depth", "acc", "weights"))}
                ok = all(errs[o] <= tol[o] for o in errs)
                shown = ", ".join(f"{o} {v:.2e} (tol {tol[o]:.0e})" for o, v in errs.items())
            else:
                r = rel(got, want)
                ok = r <= tol["grad"]
                shown = f"rel {r:.2e} (tol {tol['grad']:.0e})"
            apart = ""
            if cd == "bfloat16":
                f32 = run("float32")
                if forward:
                    dist = (flat(got) - flat(f32)).abs().max().item()
                    apart_ok = dist > ROUTE_APART_OUT
                else:
                    dist = rel(got, f32)
                    apart_ok = dist > ROUTE_APART_GRAD
                apart = f"; vs the float32 route {dist:.2e}"
                if not apart_ok:
                    raise RuntimeError(f"{label}: bfloat16 reads {dist} from the float32 route")
            k64, p64 = rel(got, exact), rel(want, exact)
            ms = cuda_ms(lambda: run(cd), iters=10 if flops < 2e11 else 5)
            plain_ms = cuda_ms(lambda: plain(cd), iters=3 if flops < 2e11 else 2)
            if cd == "float32":
                b_ms, b_by, rate = bounds(flops, nbytes, tensor_cores=True)
            else:
                b_ms, b_by, rate = route_bounds(flops, nbytes, cd)
            print(f"  {label}: vs plain {shown}, max abs err {max_err:.2e}; bit-equal; vs a "
                  f"float64 run at the route: kernel rel {k64:.2e}, plain rel {p64:.2e}{apart}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} "
                  f"({rate}; {flops / 1e9:.1f} GFLOP; share {b_ms / ms:.1%})", flush=True)
            if not ok:
                raise RuntimeError(f"{label}: kernel disagrees with its plain version: {shown}")
            if cd != "float32" and not k64 <= F64_FACTOR * p64:
                raise RuntimeError(f"{label}: kernel rel {k64} from float64, plain {p64} "
                                   f"(factor {F64_FACTOR})")
            if width in launch_widths and kernel in ("train_pe", "render_bwd"):
                print_launch_times(f"{label}", lambda: run(cd))
            rows[(kernel, width, cd)] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                             bound_ms=b_ms, bound_by=b_by, bound_rate=rate,
                                             f64_rel=k64, plain_f64_rel=p64)
    return rows


def run_route_training(cfg, train, test, device, tk, tt, f32_losses):
    """``baseline.yaml`` at ``rendering.compute_dtype`` bfloat16, then
    highest, from the float32 slice's seed (same init, batches and jitter):
    eval at init, ROUTE_EPOCHS through kernel 1 (once per step), eval
    after (PSNR must rise; kernel 2 once per chunk), ROUTE_RENDER_STEPS
    differentiable render steps (kernels 4 and 3) and one
    ``inline_pe=False`` step (kernel 5), all at the route. Epoch 0's
    per-step losses: highest within rel TRAIN_LOSS_RTOL of the plain
    trainer's (``f32_losses["plain"]``), bfloat16 within rel BF16_LOSS_BAND
    of the float32 kernel trainer's. Every count is set to 0 before each
    route and each of the five kernels must have launched. Returns
    ``{route: launches}``."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    out = {}
    for cd in ROUTES:
        rcfg = config_from_dict({**BASELINE_CONFIG, "rendering": {
            **BASELINE_CONFIG["rendering"], "compute_dtype": cd}})
        tr = Trainer(rcfg, train, test, device=device)
        if not tr._use_fused() or tr.kernel_path != "kernel":
            raise RuntimeError(f"{cd}: kernel_path {tr.kernel_path} ({tr.kernel_path_reason})")
        for i in range(len(rcfg.phases)):
            tr.phase_data(i)
        tk.fused_render_fwd_pe.launches = tk.fused_render_fwd.launches = 0
        tk.fused_render_bwd.launches = 0
        tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
        psnr0 = tr.evaluate()["psnr"]
        steps, losses = 0, {}
        for e in ROUTE_EPOCHS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.train_epoch(e)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            n = len(tr.last_step_losses)
            steps += n
            losses[e] = tr.last_step_losses.copy()
            if not np.isfinite(losses[e]).all():
                raise RuntimeError(f"{cd} epoch {e}: non-finite losses")
            print(f"  {cd} epoch {e}: loss {loss:.6f}, {n} steps, {sec / n * 1e3:.3f} ms/step",
                  flush=True)
        after = tr.evaluate()["psnr"]
        ref = f32_losses["plain" if cd == "highest" else "kernel"]
        gap = float(np.max(np.abs(losses[0] / ref - 1.0)))
        band = TRAIN_LOSS_RTOL if cd == "highest" else BF16_LOSS_BAND
        print(f"  {cd}: psnr {psnr0:.4f} dB at init, {after:.4f} dB after; epoch 0 per-step "
              f"max rel gap to the {'plain (xla)' if cd == 'highest' else 'float32 kernel'} "
              f"trainer {gap:.2e} (band {band:.0e})", flush=True)
        if not gap <= band:
            raise RuntimeError(f"{cd}: epoch 0 losses {gap} from the reference (band {band})")
        if not after > psnr0:
            raise RuntimeError(f"{cd}: psnr after training {after} <= at init {psnr0}")
        pd = tr.phase_data(len(rcfg.phases) - 1)
        step = render_stepper(rcfg, pd, device, 0, fused=True, compute_dtype=cd)
        render_losses = [step().item() for _ in range(ROUTE_RENDER_STEPS)]
        a, o = main_path_train_args(tr, len(rcfg.phases) - 1, device, inline_pe=False)
        x_loss = tt.fused_train_objective(*a, **{**o, "compute_dtype": cd})[0].item()
        if not np.isfinite(render_losses + [x_loss]).all():
            raise RuntimeError(f"{cd}: non-finite render or x-input losses")
        counts = {"train_pe": tt.fused_train_objective.launches["train_pe"],
                  "fwd_pe": tk.fused_render_fwd_pe.launches,
                  "fwd": tk.fused_render_fwd.launches, "render_bwd": tk.fused_render_bwd.launches,
                  "train_x": tt.fused_train_objective.launches["train_x"]}
        chunks = 2 * -(-N_TEST_VIEWS * rcfg.data.resolution ** 2 // rcfg.rendering.chunk_size)
        print(f"  {cd} launches: {counts} for {steps} steps, {chunks} eval chunks, "
              f"{ROUTE_RENDER_STEPS} render steps, 1 x-input step", flush=True)
        want = {"train_pe": steps, "fwd_pe": chunks, "fwd": ROUTE_RENDER_STEPS,
                "render_bwd": ROUTE_RENDER_STEPS, "train_x": 1}
        if counts != want:
            raise RuntimeError(f"{cd}: launches {counts}, expected {want}")
        out[cd] = counts
    return out


def wide_config(hidden_dim, backend="auto", lr=None):
    """``experiments/baseline.yaml`` with ``nerf_model.hidden_dim`` set to a
    trunk width the JAX kernels take and no shipped config uses (the JAX
    trainer sends any multiple of 128 to its kernels), built in code; the
    published widths otherwise (8 layers, pos_freq 10, view directions);
    ``lr``: ``optimizer.lr`` in place of the published one."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict

    optimizer = {**BASELINE_CONFIG["optimizer"], **({"lr": lr} if lr else {})}
    return config_from_dict({**BASELINE_CONFIG, "nerf_model": {
        **BASELINE_CONFIG["nerf_model"], "hidden_dim": hidden_dim}, "rendering": {
        **BASELINE_CONFIG["rendering"], "backend": backend}, "optimizer": optimizer})


def run_wide_slice(hidden_dim, train, test, device, tk, tt):
    """``baseline.yaml`` at trunk width ``hidden_dim`` (``wide_config``)
    through ``Trainer(device="cuda")``: the five kernels at every route on
    the trainer's init at the main path's shapes (``route_cases``,
    ``run_route_kernels``); then, with every count set
    to 0, eval at init (kernel 2 once per chunk), ``train_epoch`` at
    ``WIDE_EPOCHS[hidden_dim]`` (kernel 1 once per step; epoch 0's per-step
    losses within rel TRAIN_LOSS_RTOL of a ``backend: xla`` trainer from the
    same seed, batches and jitter; also the later epochs of
    WIDE_TWIN_EPOCHS), eval after (PSNR above init by the epoch of
    WIDE_PSNR_RISE, with an eval there),
    WIDE_RENDER_STEPS differentiable render steps (kernels 4 and 3; per-step
    losses within rel TRAIN_LOSS_RTOL of plain autograd) and one
    ``inline_pe=False`` step (kernel 5) against its plain version; the
    counts read after. Returns ``(rows, launches)``."""
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    lr = WIDE_LR.get(hidden_dim)
    cfg, pcfg = wide_config(hidden_dim, lr=lr), wide_config(hidden_dim, "xla", lr=lr)
    n = cfg.nerf
    if (n.hidden_dim, n.num_layers, n.pos_freq, cfg.phases[-1].n_samples,
            cfg.rendering.chunk_size) != (hidden_dim, 8, 10, 64, 2048):
        raise RuntimeError(f"wide config widths {n}")
    ktr = Trainer(cfg, train, test, device=device)
    ptr = Trainer(pcfg, train, test, device=device)
    if not ktr._use_fused() or ktr.kernel_path != "kernel" or ptr._use_fused():
        raise RuntimeError(f"H {hidden_dim}: kernel_path {ktr.kernel_path} "
                           f"({ktr.kernel_path_reason}); xla must take the plain path")
    label = f"h{hidden_dim}"
    rows = run_route_kernels(route_cases(ktr, test, device, label, dino=False),
                             ("float32", *ROUTES), (label,))
    last = len(cfg.phases) - 1
    for i in range(len(cfg.phases)):
        ktr.phase_data(i)
        ptr.phase_data(i)
    if lr is not None:  # the published lr: epoch 0 on both paths, then eval
        twins = [Trainer(wide_config(hidden_dim, b), train, test, device=device)
                 for b in ("auto", "xla")]
        e0 = WIDE_EPOCHS[hidden_dim][0]
        for t in twins:
            t.train_epoch(e0)
        gap = float(np.max(np.abs(twins[1].last_step_losses / twins[0].last_step_losses - 1.0)))
        read = [(t.evaluate()["psnr"], t.dead_sigma_probe()) for t in twins]
        print(f"  H {hidden_dim} at the published lr {BASELINE_CONFIG['optimizer']['lr']}: epoch "
              f"{e0} per-step max rel gap kernel / xla {gap:.2e}; psnr after {read[0][0]:.4f} / "
              f"{read[1][0]:.4f} dB, dead-sigma probe {read[0][1]:.3e} / {read[1][1]:.3e}",
              flush=True)
        if not (gap <= TRAIN_LOSS_RTOL and abs(read[0][0] - read[1][0]) <= 1e-3):
            raise RuntimeError(f"H {hidden_dim} at the published lr: kernel and xla apart")

    tk.fused_render_fwd_pe.launches = tk.fused_render_fwd.launches = 0
    tk.fused_render_bwd.launches = 0
    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    psnr0 = ktr.evaluate()["psnr"]
    steps, losses, evals = 0, {}, 1
    rise_at, risen = WIDE_PSNR_RISE.get(hidden_dim), None
    for e in WIDE_EPOCHS[hidden_dim]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ktr.train_epoch(e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        k = len(ktr.last_step_losses)
        steps += k
        losses[e] = ktr.last_step_losses.copy()
        if not np.isfinite(losses[e]).all():
            raise RuntimeError(f"H {hidden_dim} epoch {e}: non-finite losses")
        print(f"  H {hidden_dim} kernel trainer epoch {e}: loss {loss:.6f}, {k} steps, "
              f"{sec / k * 1e3:.3f} ms/step", flush=True)
        if e == rise_at and e != WIDE_EPOCHS[hidden_dim][-1]:
            risen = ktr.evaluate()["psnr"]
            evals += 1
    after = ktr.evaluate()["psnr"]
    evals += 1
    risen = after if risen is None else risen
    gaps = {}
    for e in WIDE_TWIN_EPOCHS.get(hidden_dim, WIDE_EPOCHS[hidden_dim][:1]):
        ptr.train_epoch(e)
        gaps[e] = float(np.max(np.abs(ptr.last_step_losses / losses[e] - 1.0)))
    rise = "" if rise_at is None else f", {risen:.4f} dB after epoch {rise_at} (gate)"
    print(f"  H {hidden_dim}: psnr {psnr0:.4f} dB at init{rise}, {after:.4f} dB after; per-step "
          f"max rel gap to the xla trainer by epoch "
          f"{ {e: f'{v:.2e}' for e, v in gaps.items()} } (tol {TRAIN_LOSS_RTOL:.0e})", flush=True)
    if not max(gaps.values()) <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"H {hidden_dim}: losses {gaps} from the xla trainer")
    if rise_at is not None and not risen > psnr0:
        raise RuntimeError(f"H {hidden_dim}: psnr after epoch {rise_at} {risen} <= at init {psnr0}")
    pd = ktr.phase_data(last)
    fused = render_stepper(cfg, pd, device, 0, fused=True)
    plain = render_stepper(cfg, pd, device, 0, fused=False)
    got = np.array([fused().item() for _ in range(WIDE_RENDER_STEPS)])
    want = np.array([plain().item() for _ in range(WIDE_RENDER_STEPS)])
    render_gap = float(np.max(np.abs(got / want - 1.0)))
    a, o = main_path_train_args(ktr, last, device, inline_pe=False)
    x_err = compare_train(f"H {hidden_dim} inline_pe=False step (kernel 5)",
                          tt.fused_train_objective(*a, **o),
                          tt.fused_train_objective_reference(*a, **o), TRAIN_GRAD_TOL)
    counts = {"train_pe": tt.fused_train_objective.launches["train_pe"],
              "fwd_pe": tk.fused_render_fwd_pe.launches, "fwd": tk.fused_render_fwd.launches,
              "render_bwd": tk.fused_render_bwd.launches,
              "train_x": tt.fused_train_objective.launches["train_x"]}
    chunks = evals * -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    print(f"  H {hidden_dim}: {WIDE_RENDER_STEPS} render steps, per-step max rel gap to plain "
          f"autograd {render_gap:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); launches {counts} for {steps} "
          f"steps, {chunks} eval chunks, {WIDE_RENDER_STEPS} render steps, 1 x-input step "
          f"(max abs err {x_err:.2e})", flush=True)
    if not (np.isfinite(got).all() and render_gap <= TRAIN_LOSS_RTOL):
        raise RuntimeError(f"H {hidden_dim}: fused render steps {got} vs plain {want}")
    expect = {"train_pe": steps, "fwd_pe": chunks, "fwd": WIDE_RENDER_STEPS,
              "render_bwd": WIDE_RENDER_STEPS, "train_x": 1}
    if counts != expect:
        raise RuntimeError(f"H {hidden_dim}: launches {counts}, expected {expect}")
    return rows, counts


def cap_config(which, backend="auto"):
    """The caps phase's config ``which`` (``CAP_TRAINERS``) at a backend."""
    from nerf_fewshot_tpu_torch.training.config import config_from_dict, load_config

    if which == "samples":
        raw = {**HIERARCHICAL_CONFIG,
               "training": {**HIERARCHICAL_CONFIG["training"], "batch_size": 128},
               "rendering": {**HIERARCHICAL_CONFIG["rendering"], "n_importance": 1056}}
    elif which == "layers":
        raw = {**BASELINE_CONFIG, "nerf_model": {**BASELINE_CONFIG["nerf_model"],
                                                 "num_layers": 16}}
    else:
        raw = load_config(os.path.join(ROOT, "experiments", "dino_nerf.yaml")).raw
        raw = {**raw, "model": {**raw["model"], "dino_dim": 1024}}
    return config_from_dict({**raw, "rendering": {**raw["rendering"], "backend": backend}})


@contextmanager
def kernel_1_plain(tt):
    """Kernel 1's plain version in place of the kernel on the card, for a
    twin that shares everything else of a kernel trainer's step (the coarse
    pass through kernel 2 included); its calls launch and count nothing."""
    kernel = tt.fused_train_objective
    tt.fused_train_objective = tt.fused_train_objective_reference
    try:
        yield
    finally:
        tt.fused_train_objective = kernel


def run_cap_trainer(which, train, test, device, tk, tt):
    """One caps-phase config (``cap_config``) through ``Trainer(device=
    "cuda")``, every count set to 0 before it and read after: epoch 0
    through kernel 1 once per step (with importance sampling, kernel 2 as
    each step's coarse pass), its per-step losses within rel
    TRAIN_LOSS_RTOL of a ``backend: xla`` twin (same seed, batches, jitter,
    features). With 1,056 importance samples the xla twin's coarse weights
    (the plain pipeline's: cos, not kernel 2's sin(x + pi/2), and sums in
    another order) move the importance samples enough to reach the losses
    (INLINE_PE_LOSS_RTOL: the xla twin is held there; at the shipped 64
    they agree to 1e-7), so kernel 1 is held at TRAIN_LOSS_RTOL against a
    twin that differs from the kernel trainer in kernel 1 alone
    (``kernel_1_plain``);
    one eval, kernel 2 once per chunk (twice with importance
    sampling); one differentiable render step from the trained weights
    (kernels 4 and 3, with the DINO config's features) within rel
    TRAIN_LOSS_RTOL of plain autograd; one
    ``inline_pe=False`` step (kernel 5, with importance sampling kernel 4
    as its coarse pass) against its plain version. Returns the counts."""
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg, pcfg = cap_config(which), cap_config(which, "xla")
    feats = None
    if which == "width":
        rng = np.random.default_rng(cfg.seed)
        feats = rng.standard_normal((N_TRAIN_VIEWS, 9, 9, cfg.dino.output_dim)).astype(np.float32)
    ktr = Trainer(cfg, train, test, device=device, dino_features=feats)
    ptr = Trainer(pcfg, train, test, device=device, dino_features=feats)
    if not (ktr._use_fused() and ktr.kernel_path == "kernel") or ptr._use_fused():
        raise RuntimeError(f"{which}: paths {ktr.kernel_path} ({ktr.kernel_path_reason}), "
                           f"{ptr.kernel_path}")
    p0, n = cfg.phases[0], cfg.nerf
    n_imp = cfg.rendering.n_importance
    x_dim = tk.pe_layout(n.pos_freq, n.dir_freq, n.use_viewdirs,
                         cfg.dino.output_dim if ktr.use_dino else 0)[3]
    shape = (f"{min(p0.batch_size, p0.H * p0.W)} rays x {p0.n_samples} + {n_imp} samples, "
             f"{n.num_layers} x {n.hidden_dim}, MLP input {x_dim} (D {tk.pe_width(x_dim)})")
    ptr.train_epoch(0)  # the twins first: their launches are not the path's
    twins = {"xla": (ptr.last_step_losses, INLINE_PE_LOSS_RTOL if n_imp else TRAIN_LOSS_RTOL)}
    if n_imp:
        twin = Trainer(cfg, train, test, device=device, dino_features=feats)
        with kernel_1_plain(tt):
            twin.train_epoch(0)
        twins["kernel 1 plain"] = (twin.last_step_losses, TRAIN_LOSS_RTOL)
    ktr.phase_data(0)
    tk.fused_render_fwd_pe.launches = tk.fused_render_fwd.launches = 0
    tk.fused_render_bwd.launches = 0
    tt.fused_train_objective.launches = {"train_pe": 0, "train_x": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = ktr.train_epoch(0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    steps = len(ktr.last_step_losses)
    gaps = {k: (float(np.max(np.abs(l / ktr.last_step_losses - 1.0))), t)
            for k, (l, t) in twins.items()}
    print(f"  {which}: {shape}: epoch 0 loss {loss:.6f}, {steps} steps, "
          f"{sec / steps * 1e3:.3f} ms/step; per-step max rel gap to the " + ", ".join(
              f"{k} twin {g:.2e} (tol {t:.0e})" for k, (g, t) in gaps.items()), flush=True)
    if not (np.isfinite(ktr.last_step_losses).all() and all(g <= t for g, t in gaps.values())):
        raise RuntimeError(f"{which}: epoch 0 losses from the twins {gaps}")
    metrics = ktr.evaluate()
    chunks = -(-N_TEST_VIEWS * cfg.data.resolution ** 2 // cfg.rendering.chunk_size)
    # kernel 2: the steps' coarse passes and each eval chunk's passes;
    # kernel 4: the render step's passes and the x step's coarse pass
    expect = {"train_pe": steps, "fwd_pe": steps * (n_imp > 0) + chunks * (2 if n_imp else 1),
              "fwd": 3 if n_imp else 1, "render_bwd": 1, "train_x": 1}
    if not np.isfinite(metrics["psnr"]):
        raise RuntimeError(f"{which}: eval psnr {metrics['psnr']}")
    last = len(cfg.phases) - 1
    pd = ktr.phase_data(last)
    got = render_stepper(cfg, pd, device, n_imp, fused=True, trainer=ktr)().item()
    want = render_stepper(cfg, pd, device, n_imp, fused=False, trainer=ktr)().item()
    if not (np.isfinite(got) and abs(got / want - 1.0) <= TRAIN_LOSS_RTOL):
        raise RuntimeError(f"{which}: fused render step {got} vs plain {want}")
    print(f"  {which}: a differentiable render step ({cfg.phases[last].batch_size} rays x "
          f"{cfg.phases[last].n_samples} + {n_imp} samples) rel gap to plain autograd "
          f"{abs(got / want - 1.0):.2e}", flush=True)
    a, o = main_path_train_args(ktr, last, device, inline_pe=False)
    x_err = compare_train_or_f64(f"{which} inline_pe=False step (kernel 5, x {a[0].shape[1]} "
                                 f"wide, {a[2].shape[0]}x{a[2].shape[1]})", a, o, tt)
    counts = {"train_pe": tt.fused_train_objective.launches["train_pe"],
              "fwd_pe": tk.fused_render_fwd_pe.launches, "fwd": tk.fused_render_fwd.launches,
              "render_bwd": tk.fused_render_bwd.launches,
              "train_x": tt.fused_train_objective.launches["train_x"]}
    print(f"  {which}: eval psnr {metrics['psnr']:.4f} dB, {eval_ms(ktr)}; launches {counts} for "
          f"{steps} steps, {chunks} eval chunks (max abs err of the x step {x_err:.2e})",
          flush=True)
    if counts != expect:
        raise RuntimeError(f"{which}: launches {counts}, expected {expect}")
    return counts


def run_caps_phase(train, test, device, tk, tt, smi):
    """Past the caps the kernels once had: every kernel at ``CAP_CASES`` against its
    plain version at the routes named there (``run_route_kernels``: the §2
    gates, two calls bit for bit, times, bounds and shares, the card's
    ``nvidia-smi`` name and power limit beside them), then the three
    ``CAP_TRAINERS`` (``run_cap_trainer``). Returns ``(rows, launches)``."""
    print(f"  {smi}", flush=True)
    rows = {}
    for label, (shape, routes) in CAP_CASES.items():
        cases = [cap_case(kernel, label, shape, device) for kernel in CAP_KERNELS]
        rows.update(run_route_kernels(cases, routes, ()))
        del cases
    launches = {which: run_cap_trainer(which, train, test, device, tk, tt)
                for which in CAP_TRAINERS}
    return rows, launches


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

    with phase("precision routes: kernels vs plain"):
        route_rows = run_route_kernels(route_cases(trainer, test, device))

    with phase("routes and kernel times vs the parent build"):
        run_parent_bits()

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
            train_launches, x_launches, trained, epoch0, adam_launches = run_train_slice(
                cfg, train, test, device, tmp, metrics["psnr"], tt)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    with phase("precision routes: baseline.yaml training"):
        route_launches = run_route_training(cfg, train, test, device, tk, tt, epoch0)

    with phase("evaluate baseline.yaml"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
        try:
            eval_launches, eval_sampler = {}, {}
            eval_launches["baseline.yaml"], eval_sampler["baseline.yaml"] = run_evaluate_phase(
                "baseline.yaml", trained, train, test, device, tk, smi, tmp)
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
                        trace_epoch(trainer, epoch, with_cpu), untraced_ms, max_syncs=1)
        no_sync_run(f"epoch {epoch}'s steps", lambda: trainer.epoch_steps(epoch))
        views = no_sync_run("render_views_device of the 8 test views",
                            lambda: trainer.render_views_device(test.poses))
        if not all(torch.isfinite(v).all() for v in views):
            raise RuntimeError("render_views_device: non-finite views")
        trace_views = trace(lambda: len([trainer.render_views(test.poses)]), with_cpu=False)
        print(f"  render_views of the 8 test views traced: {trace_views['syncs_total']} stream "
              f"synchronizations, {trace_views['launches']:.1f} launches, wall "
              f"{trace_views['wall_ms']:.1f} ms, device busy {trace_views['busy_ms']:.1f} ms",
              flush=True)
        if trace_views["syncs_total"] > 1:
            raise RuntimeError(f"render_views: {trace_views['syncs_total']} synchronizations")
        adam_layouts_report(trainer)
        adam_row = run_adam_gate(device)

    with phase("graph vs eager step"):
        run_graph_vs_eager(train, test, device)

    with phase("hierarchical train slice"):
        x_launches_hier = run_hierarchical_slice(train, test, device, tk, tt)

    with phase("repair check"):
        run_repair_check(train, device, tk, tt)

    wide = {}
    for hidden in WIDE_WIDTHS + WIDER_WIDTHS:
        with phase(f"{'wider' if hidden > MAX_FIXED_WIDTH else 'wide'} trunk H {hidden}"):
            wide[hidden] = run_wide_slice(hidden, train, test, device, tk, tt)

    with phase("past the old caps: samples, depth, input width"):
        cap_rows, cap_launches = run_caps_phase(train, test, device, tk, tt, smi)

    with phase("DINO kernel widths"):
        dino_rows = run_dino_kernel_widths(device, tk, tt)

    with phase("feature sampler kernel"):
        sampler_rows = run_sampler_kernel(train, device)

    dino = {}
    for name in DINO_CONFIGS:
        with phase(f"DINO slice {name}"):
            dino[name] = run_dino_slice(name, train, test, device, tk, tt)
        if name == "dino_nerf.yaml":
            with phase(f"evaluate {name}"):
                tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
                try:
                    eval_launches[name], eval_sampler[name] = run_evaluate_phase(
                        name, dino[name]["trainer"], train, test, device, tk, smi, tmp)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        del dino[name]["trainer"]

    with phase("LoRA trunk kernel width"):
        lora_rows = run_lora_kernel_width(device, tk, tt)

    with phase("LoRA pack kernels"):
        pack_rows = run_lora_pack_kernels(device)

    with phase(f"LoRA trunk slice {LORA_TRUNK_CONFIG}"):
        lora = run_lora_trunk_slice(train, test, device, tk, tt)

    with phase("LoRA trunk past the pack kernels' old caps"):
        lora_caps = run_lora_cap_trainers(train, test, device, tk, tt, lora["feats"])

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

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dinov2_")
    try:
        with phase("pretrained-format DINOv2"):
            dino[PRETRAINED_LABEL], weights_root = run_pretrained_dino(
                train, test, device, tk, tt, tmp)
            del dino[PRETRAINED_LABEL]["trainer"]
        with phase("dino_lora dumper"):
            run_dumper(device, tmp, weights_root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase("kernel gradient gate"):
        gate_launches = run_gradient_gate(tt)

    with phase("sigma noise"):
        run_sigma_noise(train, test, device, tk, tt)

    with phase("CLI"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        try:
            run_cli(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    with phase("data parallel"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
        try:
            dp_train, dp_eval, dp_adam, dp_ranks, dp_sampler, dp_lora = run_data_parallel(
                device, tk, tmp, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # the sampler kernel's launches on the main path, by run
    sampler_launches = {**{n: dino[n]["sampler_launches"] for n in dino},
                        **{n: script[n]["sampler_launches"] for n in SCRIPT_EPOCHS},
                        "cli evaluate dino_nerf.yaml": eval_sampler["dino_nerf.yaml"],
                        "dino_nerf.yaml data parallel world 1 nccl": dp_sampler["world 1 nccl"],
                        "dino_nerf.yaml data parallel world 2 gloo, both ranks":
                            sum(dp_sampler["world 2 gloo per rank"])}
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

    single = [n for n in dino if dino[n]["d"] == 176]
    multi = [n for n in dino if dino[n]["d"] == 240]
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
               "launches": lora["launches" if train else "eval_launches"]
               + sum(c["train_pe" if train else "eval_fwd_pe"] for c in lora_caps.values()),
               "launches_past_the_pack_caps": {
                   f"{LORA_TRUNK_CONFIG} {k}": c["train_pe" if train else "eval_fwd_pe"]
                   for k, c in lora_caps.items()},
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

    replaces = {"fwd_pe": ("fwd_pe", "kernels.py:251"), "fwd": ("fwd_pe", "kernels.py:139"),
                "render_bwd": ("train_pe", "kernels.py:292"),
                "train_pe": ("train_pe", "train_kernel.py:343"),
                "train_x": ("train_pe", "train_kernel.py:320")}
    route_kernel_rows = []
    for kernel, (source, where) in replaces.items():
        for cd in ROUTES:
            main, dino = route_rows[(kernel, "d96", cd)], route_rows[(kernel, "d176", cd)]
            route_kernel_rows.append({
                "name": f"{kernel}_{ROUTE_SHORT[cd]}", "route": "cuda",
                "source": f"nerf_fewshot_tpu_torch/csrc/{source}.cu",
                "replaces": f"nerf_fewshot_tpu/render/{where}", "compute_dtype": cd,
                "configs": [f"baseline.yaml compute_dtype {cd}"],
                "launches": route_launches[cd][kernel],
                "max_abs_err": max(main["max_abs_err"], dino["max_abs_err"]),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "bound_rate": main["bound_rate"],
                "library_ms": None, "f64_rel": main["f64_rel"],
                "plain_f64_rel": main["plain_f64_rel"],
                "at_d176": {k: dino[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}})

    wide_sources = {"fwd_pe": ("fwd_pe", "kernels.py:251"), "fwd": ("fwd_pe", "kernels.py:139"),
                    "render_bwd": ("train_pe", "kernels.py:292"),
                    "train_pe": ("train_pe", "train_kernel.py:343"),
                    "train_x": ("train_pe", "train_kernel.py:320")}
    wide_kernel_rows = []
    for hidden in sorted(wide):
        rows, counts = wide[hidden]
        for kernel, (source, where) in wide_sources.items():
            f32 = rows[(kernel, f"h{hidden}", "float32")]
            wide_kernel_rows.append({
                "name": f"{kernel}_h{hidden}", "route": "cuda",
                "source": f"nerf_fewshot_tpu_torch/csrc/{source}.cu",
                "replaces": f"nerf_fewshot_tpu/render/{where}",
                "configs": [f"baseline.yaml hidden_dim {hidden}" +
                            (f" lr {WIDE_LR[hidden]}" if hidden in WIDE_LR else "")],
                "build": "generic" if hidden > MAX_FIXED_WIDTH else f"h{hidden}",
                "shape": "2048x64" if kernel in ("fwd_pe", "fwd") else "512x64",
                "launches": counts[kernel],
                **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "bound_rate")},
                "library_ms": None,
                "routes": {cd: {k: rows[(kernel, f"h{hidden}", cd)][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_rate", "f64_rel",
                    "plain_f64_rel")} for cd in ROUTES}})

    cap_kernel_rows = []
    for which, labels in CAP_ROWS.items():
        for label in labels:
            shape, routes = CAP_CASES[label]
            for kernel, (source, where) in wide_sources.items():
                f32 = cap_rows[(kernel, label, "float32")]
                cap_kernel_rows.append({
                    "name": f"{kernel}_{label}", "route": "cuda",
                    "source": f"nerf_fewshot_tpu_torch/csrc/{source}.cu",
                    "replaces": f"nerf_fewshot_tpu/render/{where}",
                    "shape": "R %d x S %d, %d x %d, features %d" % shape,
                    "configs": [CAP_CONFIG_NAMES[which]],
                    "launches": cap_launches[which][kernel],
                    **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "bound_rate")},
                    "library_ms": None,
                    "routes": {cd: {k: cap_rows[(kernel, label, cd)][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_rate", "f64_rel",
                        "plain_f64_rel")} for cd in routes if cd != "float32"}})

    def pack_row(kernel, k):
        key = ("fwd", "vjp")[k]
        row = pack_rows[next(iter(LORA_PACK_CASES))]
        runs = {f"{LORA_TRUNK_CONFIG} train": lora["pack_launches"][k],
                f"{LORA_TRUNK_CONFIG} eval": lora["eval_packs"] if k == 0 else 0,
                **{f"{n} train": script[n]["pack_launches"][k]
                   for n in ("script_lora.yaml", "script_projection.yaml")},
                f"{LORA_TRUNK_CONFIG} data parallel world 1 nccl (graph and eager)":
                    sum(dp_lora[f"world 1 nccl {m}"][k] for m in ("graph", "eager")),
                **{f"{LORA_TRUNK_CONFIG} {label} train and eval":
                   c[kernel] + (c["eval_lora_pack"] if k == 0 else 0)
                   for label, c in lora_caps.items()}}
        return {
            "name": kernel, "route": "cuda", "source": "nerf_fewshot_tpu_torch/csrc/lora_pack.cu",
            "replaces": "nerf_fewshot_tpu/render/kernels.py:660",
            "replaces_note": "no pallas_call: jax.vjp over pack_params of a LoRA trunk (the "
                             "merge W + (alpha/r) A @ B, render/kernels.py:679-684), which XLA "
                             "fuses into the jitted step (render/train_kernel.py:720-747)",
            "shape": f"{row['shape']} ({next(iter(LORA_PACK_CASES))})",
            "configs": list(runs), "launches": sum(runs.values()), "launches_by_run": runs,
            "max_abs_err": max(r["max_abs_err"][key] for r in pack_rows.values()),
            "ms": row["ms"][key], "plain_ms": row["ms"][key + "_plain"],
            "plain": "_pack_merged" if k == 0 else "torch.autograd.grad through _pack_merged",
            "bound_ms": row["bound_ms"][key], "bound_by": row["bound_by"][key],
            "bound_rate": row["bound_rate"][key],
            "library_ms": row["ms"]["baddbmm"] if k == 0 else None,
            "library": ("torch.baddbmm of layers 1.. of the merge, TF32 off: a partial "
                        "yardstick (no layer 0, no permutation, no heads), never called by "
                        "the port") if k == 0 else None,
            "timing": "device ms a call: 20 calls captured in a CUDA graph, replayed between "
                      "CUDA events",
            "cases": {label: {"ms": r["ms"][key], "plain_ms": r["ms"][key + "_plain"],
                              "bound_ms": r["bound_ms"][key], "bound_by": r["bound_by"][key],
                              "bound_rate": r["bound_rate"][key], "bytes": r["bytes"][key],
                              "launches_a_call": r["launches_a_call"], "shape": r["shape"],
                              "max_abs_err": r["max_abs_err"][key],
                              **({"vjp_rel": r["vjp_rel"], "vjp_f64": r["vjp_f64"],
                                  "vjp_plain_f64": r["vjp_plain_f64"]} if k else
                                 {"baddbmm_ms": r["ms"]["baddbmm"]})}
                      for label, r in pack_rows.items()}}

    srow = sampler_rows[SAMPLER_ROW]
    sampler_row = {
        "name": "point_features", "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/point_features.cu",
        "replaces": "nerf_fewshot_tpu/training/trainer.py:76",
        "replaces_note": "no pallas_call: XLA's fusion of the JAX trainer's sampler closure "
                         "(_feature_sampler, training/trainer.py:76-105: project_points_to_image "
                         "or project_points_script, then grid_sample)",
        "shape": f"{srow['points']} points, maps {list(srow['maps'])} ({SAMPLER_ROW})",
        "configs": list(sampler_launches), "launches": sum(sampler_launches.values()),
        "launches_by_run": sampler_launches,
        "max_abs_err": max(max(r["max_abs_err"], r.get("max_abs_err_two_ranks", 0.0))
                           for r in sampler_rows.values()),
        "ms": srow["ms"], "plain_ms": srow["plain_ms"], "bound_ms": srow["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timing": "device ms a call: 20 calls captured in a CUDA graph, replayed between CUDA "
                  "events (ms_event_loop: a loop of calls from the host)",
        "grid_sample_taps_ms": srow["grid_sample_ms"],
        "grid_sample_note": "F.grid_sample of the taps alone: a yardstick for part of the "
                            "function (no projection, no mask), never called by the port",
        "cases": {k: {key: (list(v) if isinstance(v, tuple) else v) for key, v in r.items()}
                  for k, r in sampler_rows.items()}}

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fwd_pe",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/fwd_pe.cu",
        "replaces": "nerf_fewshot_tpu/render/kernels.py:251",
        "configs": ["baseline.yaml", "cli evaluate baseline.yaml",
                    "baseline.yaml data parallel"],
        "launches": launches + eval_launches["baseline.yaml"] + dp_eval,
        "launches_cli_evaluate": {"baseline.yaml": eval_launches["baseline.yaml"]},
        "launches_data_parallel": {"world 1 nccl eval": dp_eval},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_rate": "3xTF32 at 495 TFLOP/s",
        "bound_fp32_ms": bound32_ms,
        "library_ms": None,
    }, {**train_row("train_pe", 343, train_launches + gate_launches + dp_train),
        "launches_kernel_gradient_check": gate_launches,
        "launches_data_parallel": {"world 1 nccl graph replays": dp_train,
                                   "world 2 gloo per rank": dp_ranks}},
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
    }, {
        "name": "adam",
        "route": "cuda",
        "source": "nerf_fewshot_tpu_torch/csrc/adam.cu",
        "replaces": "nerf_fewshot_tpu/training/optim.py:56",
        "replaces_note": "no pallas_call: the optax chain (add_decayed_weights, scale_by_adam) "
                         "that XLA fuses into the JAX trainer's epoch_fn (training/trainer.py:474)",
        "configs": ["baseline.yaml", "baseline.yaml data parallel"],
        "launches": adam_launches + dp_adam,
        "launches_data_parallel": {"world 1 nccl graph replays": dp_adam},
        "max_abs_err": adam_row["max_abs_err"],
        "ms": adam_row["ms"],
        "plain_ms": adam_row["plain_ms"],
        "plain": "torch.optim.Adam(foreach=True)",
        "bound_ms": adam_row["bound_ms"],
        "bound_by": adam_row["bound_by"],
        "library_ms": adam_row["library_ms"],
        "library": "torch.optim.Adam(fused=True)",
        "timing": "device ms a step (torch.profiler kernel time)",
        "wall_ms_of_a_loop": adam_row["wall_ms"],
    }, sampler_row, *dino_kernel_rows, lora_row("train_pe"), lora_row("fwd_pe"),
        pack_row("lora_pack", 0), pack_row("lora_pack_vjp", 1), *script_kernel_rows,
        *route_kernel_rows, *wide_kernel_rows, *cap_kernel_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
