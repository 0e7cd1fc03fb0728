"""Command-line entry points of the port (counterpart of
``nerf_fewshot_tpu/cli.py``).

    python -m nerf_fewshot_tpu_torch.cli train --config experiments/dino_nerf.yaml \
        [--epochs N] [--resume CKPT] [--synthetic] [--nan-guard] [--profile DIR] [--device cpu]
    python -m nerf_fewshot_tpu_torch.cli evaluate --config ... --checkpoint CKPT \
        [--output DIR] [--n-orbit N] [--synthetic] [--device cpu]
    python -m nerf_fewshot_tpu_torch.cli extract-features --config ... [--output F.npz]

``train`` reads the experiment YAML with the port's own reader (no PyYAML
needed), loads the Blender scene or, with ``--synthetic`` or when the scene
directory is absent, the procedural scene, computes the DINO feature maps
of the training views once when the config conditions on them, trains with
``Trainer.fit``, writes ``final.ckpt`` into ``output.save_dir`` and prints
the summary JSON (``final_metrics``, ``best_psnr``, and
``dead_sigma_epochs`` when the run ended in the dead-sigma basin).
``--device`` (default ``cuda``) is the counterpart of the JAX CLI's
``NERF_TPU_PLATFORM``; a CUDA request without a card raises.

``evaluate`` builds the trainer as ``train`` does, loads ``--checkpoint``
(the port's own ``.ckpt``, a JAX package msgpack ``.ckpt`` or a reference
``.pth``) and runs the analysis harness (``training/evaluate.py``) into
``--output`` (default ``<save_dir>/evaluation``): the metric line
``[eval] PSNR ... SSIM ... LPIPS ... [backend]``, then the results JSON.

``--wandb`` sets ``output.use_wandb``: the log is mirrored to a wandb run
when the package imports and its run starts, else the JSONL/CSV sink
trains alone, as in the JAX package. Every ``dino.model_type`` that
conditions training on a feature grid is ported (``single_scale``,
``multi_scale`` and the standalone scripts' ``patch_embed``).

Not ported yet, and refused with the ROADMAP item that brings them:
``--data-parallel``, ``--multihost``, ``bench-scaling`` and
``dino.model_type: dino_lora`` (the offline token dumper).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from nerf_fewshot_tpu_torch.device import resolve_device


def _load_datasets(cfg, synthetic: bool, device):
    """(train, test): the Blender scene's first ``num_views`` train views and
    its test split, or the procedural scene (``num_views`` train, 8 test
    views) when asked or when the scene directory does not exist."""
    from nerf_fewshot_tpu_torch.data import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.data.blender import load_blender

    scene_dir = os.path.join(cfg.data.data_root, cfg.data.dataset, cfg.data.scene)
    if synthetic or cfg.data.source == "synthetic" or not os.path.isdir(scene_dir):
        if not synthetic and cfg.data.source == "blender" and not os.path.isdir(scene_dir):
            print(f"[data] {scene_dir} not found; using procedural synthetic scene")
        scene = lego_like_scene()
        train = make_scene_dataset(scene, n_views=cfg.data.num_views,
                                   img_size=cfg.data.resolution, device=device)
        test = make_scene_dataset(scene, n_views=8, img_size=cfg.data.resolution,
                                  split="test", device=device)
        return train, test
    train = load_blender(scene_dir, "train", img_size=cfg.data.resolution).few_shot(
        cfg.data.num_views)
    test = load_blender(scene_dir, "test", img_size=cfg.data.resolution)
    return train, test


@torch.no_grad()
def _precompute_features(cfg, train_data, device) -> Optional[np.ndarray]:
    """Per-view feature maps (V, Hp, Wp, Fd), computed once before training
    (the reference does the same, so its DINO-side LoRA never trains), or
    None without conditioning."""
    if not cfg.dino.use_dino:
        return None
    if cfg.dino.model_type == "dino_lora":
        raise SystemExit(
            "dino.model_type=dino_lora is the offline token dumper "
            "(extract-features); training conditions on a spatial feature "
            "grid — use single_scale/multi_scale/patch_embed")
    from nerf_fewshot_tpu_torch.models.dino import build_feature_extractor

    model = build_feature_extractor(cfg.dino, cfg.data.resolution, seed=cfg.seed, device=device)
    images = np.asarray(train_data.white_composited(), np.float32)
    return np.stack([model(torch.as_tensor(images[v], device=device)).cpu().numpy()
                     for v in range(train_data.n_views)])


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1: {item})")


def cmd_train(args) -> None:
    from nerf_fewshot_tpu_torch.training.config import load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    if args.data_parallel or args.multihost:
        _not_ported("--data-parallel / --multihost", "data parallelism")
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.wandb:
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(cfg.output, use_wandb=True))

    train_data, test_data = _load_datasets(cfg, args.synthetic, device)
    dino_features = _precompute_features(cfg, train_data, device)
    trainer = Trainer(
        cfg, train_data, test_data, device=device, dino_features=dino_features,
        log_path=os.path.join(cfg.output.save_dir,
                              "log.csv" if cfg.output.log_format == "csv" else "log.jsonl"),
    )
    if args.resume:
        trainer.load(args.resume)
        print(f"[resume] from {args.resume} at epoch {trainer.epoch}")
    if args.nan_guard:
        from nerf_fewshot_tpu_torch.utils.profiling import enable_nan_guard

        enable_nan_guard(True)
    if args.profile:
        from nerf_fewshot_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            metrics = trainer.fit()
        print(f"[profile] trace written to {args.profile}")
    else:
        metrics = trainer.fit()
    trainer.save(os.path.join(cfg.output.save_dir, "final.ckpt"))
    summary = {"final_metrics": metrics, "best_psnr": trainer.best_psnr}
    if trainer.dead_sigma_epochs:
        # the run ended inside the zero-gradient collapse basin
        summary["dead_sigma_epochs"] = trainer.dead_sigma_epochs
    print(json.dumps(summary))


def cmd_evaluate(args) -> None:
    from nerf_fewshot_tpu_torch.training.config import load_config
    from nerf_fewshot_tpu_torch.training.evaluate import comprehensive_evaluation
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    train_data, test_data = _load_datasets(cfg, args.synthetic, device)
    dino_features = _precompute_features(cfg, train_data, device)
    trainer = Trainer(cfg, train_data, test_data, device=device, dino_features=dino_features)
    trainer.load(args.checkpoint)
    out_dir = args.output or os.path.join(cfg.output.save_dir, "evaluation")
    results = comprehensive_evaluation(trainer, out_dir, n_orbit=args.n_orbit)
    m = results.get("metrics", {})
    if "lpips" in m:
        caveat = ("" if m.get("lpips_pretrained") else
                  " — random-VGG features: NOT comparable to the reference's "
                  "pretrained-VGG scale (~0.53, reference train.py:99-101)")
        print(f"[eval] PSNR {m.get('psnr', float('nan')):.2f}  "
              f"SSIM {m.get('ssim', float('nan')):.3f}  "
              f"LPIPS {m['lpips']:.4f} [{m.get('lpips_backend', 'unknown')}{caveat}]")
    print(json.dumps(results, default=float))


def cmd_extract_features(args) -> None:
    """The configured extractor's feature grids of the training views to an
    ``.npz`` (key ``features``, (V, Hp, Wp, Fd))."""
    from nerf_fewshot_tpu_torch.training.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if not cfg.dino.use_dino:
        raise SystemExit("config has model.use_dino: false — nothing to extract")
    if cfg.dino.model_type == "dino_lora":
        _not_ported("dino.model_type=dino_lora", "the dino_lora token dumper and the HF import")
    train_data, _ = _load_datasets(cfg, args.synthetic, device)
    feats = _precompute_features(cfg, train_data, device)
    out = args.output or os.path.join(cfg.output.save_dir, "features.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    np.savez_compressed(out, features=feats)
    print(json.dumps({"saved": out, "shape": list(feats.shape)}))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="nerf_fewshot_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train an experiment config")
    p_train.add_argument("--config", required=True)
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--resume", default=None)
    p_train.add_argument("--synthetic", action="store_true",
                         help="force the procedural synthetic scene")
    p_train.add_argument("--data-parallel", action="store_true", help="not ported yet")
    p_train.add_argument("--multihost", action="store_true", help="not ported yet")
    p_train.add_argument("--profile", default=None, metavar="DIR",
                         help="write a torch.profiler Chrome trace of training to DIR")
    p_train.add_argument("--nan-guard", action="store_true",
                         help="autograd anomaly mode: raise at the op whose backward "
                              "made a NaN")
    p_train.add_argument("--wandb", action="store_true",
                         help="mirror training/eval records to a wandb run when the wandb "
                              "package imports and its run starts (else the log file alone); "
                              "same as output.use_wandb: true")
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("evaluate", help="checkpoint analysis harness")
    p_eval.add_argument("--config", required=True)
    p_eval.add_argument("--checkpoint", required=True)
    p_eval.add_argument("--output", default=None)
    p_eval.add_argument("--n-orbit", type=int, default=8)
    p_eval.add_argument("--synthetic", action="store_true")
    p_eval.set_defaults(fn=cmd_evaluate)

    p_feat = sub.add_parser("extract-features", help="precompute per-view DINO feature maps")
    p_feat.add_argument("--config", required=True)
    p_feat.add_argument("--output", default=None)
    p_feat.add_argument("--synthetic", action="store_true")
    p_feat.set_defaults(fn=cmd_extract_features)

    p_scale = sub.add_parser("bench-scaling", help="not ported yet")
    p_scale.set_defaults(fn=lambda a: _not_ported("bench-scaling", "the bench"))

    for p in (p_train, p_eval, p_feat):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu; a CUDA request without a card raises")

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
