"""Command-line entry points of the port (counterpart of
``nerf_fewshot_tpu/cli.py``).

    python -m nerf_fewshot_tpu_torch.cli train --config experiments/dino_nerf.yaml \
        [--epochs N] [--resume CKPT] [--synthetic] [--nan-guard] [--profile DIR] [--device cpu] \
        [--data-parallel | --multihost]
    python -m nerf_fewshot_tpu_torch.cli evaluate --config ... --checkpoint CKPT \
        [--output DIR] [--n-orbit N] [--synthetic] [--device cpu]
    python -m nerf_fewshot_tpu_torch.cli extract-features --config ... [--output F.npz] \
        [--synthetic] [--device cpu]

``train`` reads the experiment YAML with the port's own reader (no PyYAML
needed), loads the Blender scene or, with ``--synthetic`` or when the scene
directory is absent, the procedural scene, computes the DINO feature maps
of the training views once when the config conditions on them, trains with
``Trainer.fit``, writes ``final.ckpt`` into ``output.save_dir`` and prints
the summary JSON (``final_metrics``, ``best_psnr``, and
``dead_sigma_epochs`` when the run ended in the dead-sigma basin).
``--device`` (default ``cuda``) is the counterpart of the JAX CLI's
``NERF_TPU_PLATFORM``; a CUDA request without a card raises.

``--data-parallel`` trains data parallel over the visible cards, one
spawned process per card over NCCL (``parallel/mesh.py:launch``); rank 0
writes the run's files and prints the summary, as the JAX CLI's one process
does, the other ranks write theirs into a temporary directory. With one
card (or ``--device cpu``) it trains on that device with no process group,
as the JAX CLI does with one device. ``--multihost`` joins the process
group that ``torchrun`` (or the ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` variables) describes, one process per card (or
per rank on the CPU over Gloo with ``--device cpu``), and meshes over all
ranks; every rank runs the whole command, files and summary included, as
every JAX process does. Both print the ``[mesh]`` line when a mesh is made.

``evaluate`` builds the trainer as ``train`` does, loads ``--checkpoint``
(the port's own ``.ckpt``, a JAX package msgpack ``.ckpt`` or a reference
``.pth``) and runs the analysis harness (``training/evaluate.py``) into
``--output`` (default ``<save_dir>/evaluation``): the metric line
``[eval] PSNR ... SSIM ... LPIPS ... [backend]``, then the results JSON.

``extract-features`` writes the training views' feature grids, or with
``dino.model_type: dino_lora`` the reference's offline token dump: the
patch tokens of ``LoRADINO`` on the processor input, CLS dropped, (V, 256,
768). A DINOv2 backbone takes pretrained weights found on disk
(``$NERF_DINOV2_WEIGHTS``, then the ``$HF_HOME`` hub cache).

``--wandb`` sets ``output.use_wandb``: the log is mirrored to a wandb run
when the package imports and its run starts, else the JSONL/CSV sink
trains alone, as in the JAX package. Every ``dino.model_type`` that
conditions training on a feature grid is ported (``single_scale``,
``multi_scale`` and the standalone scripts' ``patch_embed``).

Not ported, and refused with the ROADMAP item that brings it:
``bench-scaling``, whose benchmark files are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
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
def _extract(cfg, train_data, device) -> np.ndarray:
    """The configured extractor over every training view, built from the
    config's seed (with pretrained weights where they are found on disk):
    (V, Hp, Wp, Fd) feature maps, or for ``dino_lora`` the (V, 256,
    hidden) patch tokens, CLS dropped (the reference's ``features[:, 1:]``)."""
    from nerf_fewshot_tpu_torch.models.dino import build_feature_extractor

    model = build_feature_extractor(cfg.dino, cfg.data.resolution, seed=cfg.seed, device=device)
    images = np.asarray(train_data.white_composited(), np.float32)
    feats = [model(torch.as_tensor(images[v], device=device)) for v in range(train_data.n_views)]
    if cfg.dino.model_type == "dino_lora":
        feats = [f[1:] for f in feats]
    return np.stack([f.cpu().numpy() for f in feats])


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
    return _extract(cfg, train_data, device)


def _load_features(path: str, cfg, train_data) -> np.ndarray:
    """Per-view feature maps (V, Hp, Wp, Fd) from the ``maps`` array of an
    ``.npz`` (``tools/export_multiscale_maps.py`` writes the JAX package's),
    in place of the configured extractor's."""
    if not cfg.dino.use_dino:
        raise SystemExit(f"--features {path}: the config conditions on no features")
    maps = np.asarray(np.load(path)["maps"], np.float32)
    if (maps.ndim != 4 or maps.shape[0] != train_data.n_views
            or maps.shape[-1] != cfg.dino.output_dim):
        raise SystemExit(f"--features {path}: maps {maps.shape}, need ({train_data.n_views}, "
                         f"Hp, Wp, {cfg.dino.output_dim})")
    return maps


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP queue 1: {item})")


def _train(args, mesh=None, save_dir: Optional[str] = None) -> dict:
    """``train`` on one device, or on this rank of ``mesh``; ``save_dir``
    overrides ``output.save_dir``. Returns the summary."""
    from nerf_fewshot_tpu_torch.training.config import load_config
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = load_config(args.config)
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.wandb:
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(cfg.output, use_wandb=True))
    if save_dir is not None:
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(cfg.output, save_dir=save_dir))

    train_data, test_data = _load_datasets(cfg, args.synthetic, device)
    if getattr(args, "features", None):
        dino_features = _load_features(args.features, cfg, train_data)
    else:
        dino_features = _precompute_features(cfg, train_data, device)
    trainer = Trainer(
        cfg, train_data, test_data, device=device, dino_features=dino_features, mesh=mesh,
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
    return summary


def _train_rank(mesh, args) -> dict:
    """One rank of ``--data-parallel``: rank 0 writes the run's files, the
    others (no profile, no wandb run) write theirs into a temporary
    directory that they remove."""
    if mesh.rank == 0:
        return _train(args, mesh)
    args = argparse.Namespace(**{**vars(args), "profile": None, "wandb": False})
    with tempfile.TemporaryDirectory(prefix=f"rank{mesh.rank}_") as tmp:
        return _train(args, mesh, save_dir=tmp)


def cmd_train(args) -> None:
    if args.multihost:
        from nerf_fewshot_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown

        initialize_multihost(device=args.device)
        try:
            mesh = make_mesh(args.device)
            print(f"[mesh] data-parallel over {mesh.world_size} devices across "
                  f"{mesh.world_size} processes ({mesh.backend})")
            summary = _train(args, mesh)
        finally:
            shutdown()
    elif args.data_parallel and resolve_device(args.device).type == "cuda" \
            and torch.cuda.device_count() > 1:
        from nerf_fewshot_tpu_torch.parallel.mesh import launch

        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        print(f"[mesh] data-parallel over {len(devices)} devices (nccl)")
        summary = launch(_train_rank, devices, (args,), timeout_s=7 * 24 * 3600)[0]
    else:
        summary = _train(args)
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
    """The training views' features to an ``.npz`` (key ``features``): the
    configured extractor's grids (V, Hp, Wp, Fd), or with ``dino.model_type:
    dino_lora`` the reference's offline dump, ``LoRADINO``'s patch tokens
    of the processor input with CLS dropped, (V, 256, 768)."""
    from nerf_fewshot_tpu_torch.training.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if not cfg.dino.use_dino:
        raise SystemExit("config has model.use_dino: false — nothing to extract")
    train_data, _ = _load_datasets(cfg, args.synthetic, device)
    feats = _extract(cfg, train_data, device)
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
    p_train.add_argument("--data-parallel", action="store_true",
                         help="data parallel over the visible cards, one process per card")
    p_train.add_argument("--multihost", action="store_true",
                         help="join the torchrun / MASTER_ADDR process group and train data "
                              "parallel over its ranks")
    p_train.add_argument("--profile", default=None, metavar="DIR",
                         help="write a torch.profiler Chrome trace of training to DIR")
    p_train.add_argument("--nan-guard", action="store_true",
                         help="autograd anomaly mode: raise at the op whose backward "
                              "made a NaN")
    p_train.add_argument("--features", default=None, metavar="NPZ",
                         help="condition on the per-view feature maps in NPZ's 'maps' "
                              "array instead of running the configured extractor")
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

    p_scale = sub.add_parser("bench-scaling", help="not ported")
    p_scale.set_defaults(fn=lambda a: _not_ported("bench-scaling", "the bench waits for a "
                                                  "benchmark PR"))

    for p in (p_train, p_eval, p_feat):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu; a CUDA request without a card raises")

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
