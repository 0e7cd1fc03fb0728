"""Typed experiment configuration (counterpart of
``nerf_fewshot_tpu/training/config.py``): the same dataclass tree, the same
``config_from_dict`` normalisation of the reference YAML layouts, the same
validation.

``load_config`` reads the YAML with the port's own reader
(``utils/yaml_subset.py``, ``yaml.safe_load``'s typing of every scalar),
so configs load where PyYAML is absent; ``config_from_dict`` takes an
already parsed dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One progressive-resolution phase: epochs [start, end) trained at
    (H, W) with n_samples points/ray and the given ray batch size.

    The reference hardcodes three phases with batch multipliers ×2/×1/÷2
    (train.py:249-258)."""

    start_epoch: int
    end_epoch: int  # exclusive; last phase uses a large sentinel
    H: int
    W: int
    n_samples: int
    batch_size: int


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "nerf_synthetic"
    scene: str = "lego"
    num_views: int = 5
    resolution: int = 128
    near: float = 2.0
    far: float = 6.0
    data_root: str = "data"
    # 'blender' loads from disk; 'synthetic' procedurally generates a scene
    # (used when no real dataset directory is present).
    source: str = "blender"


@dataclasses.dataclass(frozen=True)
class NeRFModelConfig:
    pos_freq: int = 10
    dir_freq: int = 4
    hidden_dim: int = 256
    num_layers: int = 8
    use_viewdirs: bool = True
    # 'functional' = NeRFMLP superset (the train.py surface);
    # 'module' = NeRFWithDINO fusion stack (the train_multiscale.py surface).
    arch: str = "functional"
    # LoRA on the NeRF trunk (the missing-class scripts' surface:
    # train_lora.py:57 rank 4, train_projection.py:51 rank 16).
    lora_rank: int = 0
    lora_alpha: float = 16.0
    skip_layers: Tuple[int, ...] = ()
    # Constant sigma-head bias init (robustness against the dead-start
    # hazard; None = torch-default random bias, reference-faithful).
    sigma_bias: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    use_dino: bool = False
    # 'single_scale' = SpatialDINOFeatures (train.py's dino path);
    # 'multi_scale' = MultiScaleDINOFeatures (train_multiscale.py);
    # 'patch_embed' = torchvision ViT-B/16 patch-embedding-only conv — the
    # standalone scripts' *actual* feature source despite their "DINO"
    # naming (reference: train_baseline.py:33,55-64);
    # 'dino_lora' = the minimal LoRA-DINO token dumper used ONLY by
    # extract-features (reference: extract_features.py:20-35) — dumps
    # CLS-stripped patch tokens, not a trainable feature grid.
    model_type: str = "single_scale"
    name: str = "facebook/dinov2-base"
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: float = 16.0
    output_dim: int = 64  # single_scale 64; multi_scale 128; patch_embed 768
    # grid_sample coordinate convention when sampling feature maps at
    # projected points: the config-driven trainer uses align_corners=False
    # (dino_feature_model.py:135-140); the standalone scripts use True
    # (train_lora.py:128).
    align_corners: bool = False
    # Features of invalid projections (behind camera / out of image):
    # 'zeros' = grid_sample zero padding only (train.py:217-221);
    # 'mean' = replace with the batch-mean feature, the multiscale trainer's
    # quirk (train_multiscale.py:185-196).
    invalid_fill: str = "zeros"
    # Projection convention when mapping 3D points into the feature view:
    # 'reference' = the proper-inverse projection with a validity mask
    # (ray_utils.py:176-209, used by train.py and train_multiscale.py);
    # 'script' = the standalone scripts' inline (p - t) @ R.T chain —
    # FORWARD c2w rotation, no inverse, no mask (train_lora.py:118-124).
    # The conventions agree only for identity-rotation poses; defaulted to
    # 'script' for the patch_embed recipes (the scripts' feature source).
    projection: str = "reference"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-4
    weight_decay: float = 1e-6
    lr_milestones: Tuple[int, ...] = (100, 150)
    lr_gamma: float = 0.5
    # 'adam' = torch Adam semantics (L2 added to grad pre-moments, train.py:
    # 114-118); 'adamw' = decoupled decay (train_multiscale.py:61-65).
    kind: str = "adam"
    grad_clip: float = 0.0  # global-norm clip; 1.0 in the multiscale path
    # Two-phase training: freeze non-LoRA params from this epoch on
    # (train_lora.py:89-93 freezes at epoch 51). 0 disables.
    lora_only_after_epoch: int = 0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rgb_weight: float = 1.0
    depth_weight: float = 0.0
    reg_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    near: float = 2.0
    far: float = 6.0
    chunk_size: int = 2048
    noise_std: float = 0.0
    white_bkgd: bool = False
    n_importance: int = 0  # hierarchical fine samples (first-class here)
    lindisp: bool = False
    # 'fused' = the inline-PE kernel (functional arch, noise_std 0);
    # 'xla' = the plain pipeline; 'auto' picks fused when eligible.
    backend: str = "auto"
    # Matmul precision inside the fused kernels (render/kernels.py ROUTES):
    # 'float32' the trunk products as 3xTF32 on the tensor cores, 'bfloat16'
    # both operands of every product rounded to bf16 (the TPU runs' one bf16
    # pass), 'highest' exact fp32 FFMAs; the plain path ignores it.
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    save_dir: str = "results/default"
    val_freq: int = 10
    save_freq: int = 50
    log_freq: int = 1
    # 'jsonl' (default) or 'csv' (the reference's hand-rolled loss CSV,
    # train_dino_lora_pose.py:65,129-131).
    log_format: str = "jsonl"
    # Mirror records to a wandb run, the reference config-trainer's tracking
    # sink (train.py:345-371). Off by default; also reachable via the CLI
    # --wandb flag. The package/credentials are probed lazily — absent wandb
    # degrades to the JSONL sink alone.
    use_wandb: bool = False
    wandb_project: str = "nerf-fewshot-tpu"


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "experiment"
    description: str = ""
    epochs: int = 200
    batch_size: int = 1024
    phases: Tuple[PhaseSpec, ...] = ()
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    nerf: NeRFModelConfig = dataclasses.field(default_factory=NeRFModelConfig)
    dino: DINOConfig = dataclasses.field(default_factory=DINOConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    rendering: RenderingConfig = dataclasses.field(default_factory=RenderingConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    seed: int = 0
    # When True, reproduce the reference trainer's *actual* behavior, not its
    # config's stated intent: rgb-only loss (train.py:36-44 ignores the
    # depth/reg weights), no sigma noise (train.py:236 never forwards
    # noise_std to the renderer), and eval-time DINO features sampled from
    # train view 0 (train.py:204-213). False honors the config fields.
    strict_reference_behavior: bool = True
    # Whether downsampled phases scale focal with resolution. True mirrors
    # the config-driven trainer (train.py:267 focal_scaled); False mirrors
    # the standalone scripts and the multiscale trainer, which pass the
    # FULL-resolution focal to get_rays at downsampled sizes
    # (train_lora.py:110, train_multiscale.py:138) — low-res phases render a
    # narrow-FOV center crop. Defaults per surface in config_from_dict.
    focal_scaling: bool = True
    raw: Optional[Dict[str, Any]] = None

    def phase_for_epoch(self, epoch: int) -> PhaseSpec:
        for p in self.phases:
            if p.start_epoch <= epoch < p.end_epoch:
                return p
        return self.phases[-1]


_BIG = 10**9


def _default_phases(batch_size: int, resolution: int, schedule=None) -> Tuple[PhaseSpec, ...]:
    """Progressive schedule → explicit phases with the reference's batch
    multipliers (train.py:249-258: ×2 before epoch 50, ×1 to 100, ÷2 after)."""
    if schedule is None:
        schedule = {
            "epochs_0_50": [32, 32, 32],
            "epochs_50_100": [64, 64, 48],
            "epochs_100_plus": [resolution, resolution, 64],
        }
    s0 = schedule.get("epochs_0_50", [32, 32, 32])
    s1 = schedule.get("epochs_50_100", [64, 64, 48])
    s2 = schedule.get("epochs_100_plus", [resolution, resolution, 64])
    return (
        PhaseSpec(0, 50, s0[0], s0[1], s0[2], batch_size * 2),
        PhaseSpec(50, 100, s1[0], s1[1], s1[2], batch_size),
        PhaseSpec(100, _BIG, s2[0], s2[1], s2[2], max(batch_size // 2, 1)),
    )


def _as_int_resolution(res) -> int:
    if isinstance(res, (list, tuple)):
        return int(res[0])
    return int(res)


def config_from_dict(d: Dict[str, Any]) -> Config:
    """Build a Config from any of the reference YAML layouts."""
    exp = d.get("experiment", {}) or {}
    data_d = d.get("data", {}) or {}
    model_d = d.get("model", {}) or {}
    nerf_d = d.get("nerf_model", {}) or {}
    dino_d = d.get("dino_model", {}) or {}
    train_d = d.get("training", {}) or {}
    opt_d = d.get("optimizer", {}) or {}
    loss_d = d.get("loss", {}) or {}
    rend_d = d.get("rendering", {}) or {}
    out_d = d.get("output", {}) or {}

    # projection.yaml folds NeRF/DINO fields into `model` and optimizer/loss
    # fields into `training`; fall back field-by-field.
    def pick(*sources_key, default=None):
        for src, key in sources_key:
            if isinstance(src, dict) and key in src and src[key] is not None:
                return src[key]
        return default

    resolution = _as_int_resolution(pick((data_d, "resolution"), default=128))
    near = pick((d, "near"), (data_d, "near"), (rend_d, "near"), default=2.0)
    far = pick((d, "far"), (data_d, "far"), (rend_d, "far"), default=6.0)

    use_dino = bool(
        pick((model_d, "use_dino"),
             default=("dino_model" in model_d or "dino_dim" in model_d))
    )
    model_type = str(pick((model_d, "dino_model_type"),
                          (dino_d, "model_type"), default="single_scale"))
    dino = DINOConfig(
        use_dino=use_dino,
        model_type=model_type,
        name=pick((dino_d, "name"), (model_d, "dino_model"),
                  default="facebook/dinov2-base"),
        # dino_lora (the offline dumper) ALWAYS injects LoRA, default r=4
        # (dino_lora.py:34); the training extractors default to r=16 when
        # use_lora is opted in (dino_feature_model.py:40-44).
        use_lora=bool(pick((dino_d, "use_lora"), (model_d, "use_lora"),
                           default=(model_type == "dino_lora"))),
        lora_rank=int(pick((dino_d, "lora_rank"), (model_d, "lora_rank"),
                           default=(4 if model_type == "dino_lora" else 16))),
        lora_alpha=float(pick((dino_d, "lora_alpha"), (model_d, "lora_alpha"),
                              default=16.0)),
        output_dim=int(pick((model_d, "dino_dim"), default=64)),
        # The standalone scripts sample with align_corners=True
        # (train_lora.py:128); the config-driven path with False.
        align_corners=bool(pick(
            (dino_d, "align_corners"), (model_d, "align_corners"),
            default=(model_type == "patch_embed"),
        )),
        invalid_fill=str(pick((dino_d, "invalid_fill"), default="zeros")),
        projection=str(pick(
            (dino_d, "projection"), (model_d, "projection"),
            default=("script" if model_type == "patch_embed" else "reference"),
        )),
    )
    if dino.model_type == "multi_scale":
        dino = dataclasses.replace(dino, output_dim=128)
    elif dino.model_type == "patch_embed":
        dino = dataclasses.replace(
            dino, output_dim=int(pick((model_d, "dino_dim"), default=768))
        )

    nerf = NeRFModelConfig(
        pos_freq=int(pick((nerf_d, "pos_freq"), (model_d, "pos_freq"), default=10)),
        dir_freq=int(pick((nerf_d, "dir_freq"), (model_d, "dir_freq"), default=4)),
        hidden_dim=int(pick((nerf_d, "hidden_dim"), (model_d, "hidden_dim"),
                            default=256)),
        num_layers=int(pick((nerf_d, "num_layers"), (model_d, "num_layers"),
                            default=8)),
        use_viewdirs=bool(pick((nerf_d, "use_viewdirs"), default=True)),
        # 'functional' is the config-driven trainer's surface (train.py uses
        # NeRFMLP even for multi_scale features); 'module' selects the
        # NeRFWithDINO fusion stack (the train_multiscale.py surface).
        arch=str(pick((nerf_d, "arch"), default="functional")),
        # LoRA on the NeRF trunk (the standalone-script surface:
        # train_lora.py:57 rank 4, train_projection.py:51 rank 16)
        lora_rank=int(pick((nerf_d, "lora_rank"), default=0)),
        lora_alpha=float(pick((nerf_d, "lora_alpha"), default=16.0)),
        skip_layers=tuple(pick((nerf_d, "skip_layers"), default=())),
        sigma_bias=(
            None if pick((nerf_d, "sigma_bias"), default=None) is None
            else float(pick((nerf_d, "sigma_bias")))
        ),
    )

    # The multiscale trainer mean-fills invalid-projection features
    # (train_multiscale.py:185-196); its arch is 'module'. Default the quirk
    # on for that surface unless explicitly configured.
    if nerf.arch == "module" and pick((dino_d, "invalid_fill"), default=None) is None:
        dino = dataclasses.replace(dino, invalid_fill="mean")

    batch_size = int(pick((train_d, "batch_size"), default=1024))
    explicit_phases = "phases" in train_d
    if explicit_phases:
        # Explicit phase list (the standalone scripts' schedules don't fit
        # the 50/100 grid — e.g. train_baseline.py:74-80 switches at 20/60).
        # batch_size: 'full' = one full-image step per view (the scripts'
        # full-image loss).
        phases = []
        for ph in train_d["phases"]:
            H = int(ph.get("H", ph.get("resolution", resolution)))
            W = int(ph.get("W", H))
            bs = ph.get("batch_size", "full")
            bs = H * W if bs == "full" else int(bs)
            phases.append(PhaseSpec(
                start_epoch=int(ph["start"]),
                end_epoch=int(ph.get("end", _BIG)),
                H=H, W=W,
                n_samples=int(ph["n_samples"]),
                batch_size=bs,
            ))
        phases = tuple(phases)
    else:
        phases = _default_phases(
            batch_size, resolution, train_d.get("progressive_schedule")
        )

    optimizer = OptimizerConfig(
        lr=float(pick((opt_d, "lr"), (train_d, "learning_rate"), default=5e-4)),
        weight_decay=float(pick((opt_d, "weight_decay"),
                                (train_d, "weight_decay"), default=1e-6)),
        lr_milestones=tuple(pick((opt_d, "lr_milestones"),
                                 (train_d, "lr_milestones"), default=(100, 150))),
        lr_gamma=float(pick((opt_d, "lr_gamma"), (train_d, "lr_gamma"),
                            default=0.5)),
        kind=str(pick((opt_d, "kind"), default="adam")),
        grad_clip=float(pick((opt_d, "grad_clip"), (train_d, "grad_clip"),
                             default=0.0)),
        # Two-phase freeze boundary (train_lora.py:89-93 freezes at 51)
        lora_only_after_epoch=int(
            pick((opt_d, "lora_only_after_epoch"),
                 (train_d, "lora_only_after_epoch"), default=0)
        ),
    )
    loss = LossConfig(
        rgb_weight=float(pick((loss_d, "rgb_weight"), (train_d, "rgb_weight"),
                              default=1.0)),
        depth_weight=float(pick((loss_d, "depth_weight"),
                                (train_d, "depth_weight"), default=0.0)),
        reg_weight=float(pick((loss_d, "reg_weight"), (train_d, "reg_weight"),
                              default=0.0)),
    )
    rendering = RenderingConfig(
        near=float(near),
        far=float(far),
        chunk_size=int(pick((rend_d, "chunk_size"), default=2048)),
        noise_std=float(pick((rend_d, "noise_std"), default=0.0)),
        white_bkgd=bool(pick((rend_d, "white_bkgd"), default=False)),
        n_importance=int(pick((rend_d, "n_importance"), default=0)),
        backend=str(pick((rend_d, "backend"), default="auto")),
        compute_dtype=str(pick((rend_d, "compute_dtype"), default="float32")),
    )
    output = OutputConfig(
        save_dir=str(pick((out_d, "save_dir"), default="results/default")),
        val_freq=int(pick((out_d, "val_freq"), default=10)),
        save_freq=int(pick((out_d, "save_freq"), default=50)),
        log_freq=int(pick((out_d, "log_freq"), default=1)),
        log_format=str(pick((out_d, "log_format"), default="jsonl")),
        use_wandb=bool(pick((out_d, "use_wandb"), (d, "use_wandb"),
                            default=False)),
        wandb_project=str(pick((out_d, "wandb_project"),
                               default="nerf-fewshot-tpu")),
    )
    return validate_config(Config(
        name=str(exp.get("name", "experiment")),
        description=str(exp.get("description", "")),
        epochs=int(pick((train_d, "epochs"), default=200)),
        batch_size=batch_size,
        phases=phases,
        data=DataConfig(
            dataset=str(pick((data_d, "dataset"), default="nerf_synthetic")),
            scene=str(pick((data_d, "scene"), default="lego")),
            num_views=int(pick((data_d, "num_views"), default=5)),
            resolution=resolution,
            near=float(near),
            far=float(far),
            data_root=str(pick((data_d, "data_root"), (d, "data_root"),
                               default="data")),
            source=str(pick((data_d, "source"), default="blender")),
        ),
        nerf=nerf,
        dino=dino,
        optimizer=optimizer,
        loss=loss,
        rendering=rendering,
        output=output,
        seed=int(pick((d, "seed"), default=0)),
        strict_reference_behavior=bool(
            pick((d, "strict_reference_behavior"), default=True)
        ),
        # Only the config-driven trainer scales focal at downsampled phases
        # (train.py:267). Explicit-phase recipes (the standalone scripts)
        # and the module arch (train_multiscale) use the full-res focal.
        focal_scaling=bool(pick(
            (train_d, "focal_scaling"), (d, "focal_scaling"),
            default=not (explicit_phases or nerf.arch == "module"),
        )),
        raw=d,
    ))


_VALID = {
    "dino.model_type": {"single_scale", "multi_scale", "patch_embed",
                        "dino_lora"},
    "dino.invalid_fill": {"zeros", "mean"},
    "dino.projection": {"reference", "script"},
    "nerf.arch": {"functional", "module"},
    "rendering.backend": {"auto", "fused", "xla"},
    "rendering.compute_dtype": {"float32", "bfloat16", "highest"},
    "optimizer.kind": {"adam", "adamw"},
    "output.log_format": {"jsonl", "csv"},
}


def validate_config(cfg: Config) -> Config:
    """Reject typo'd enum fields up front (a misspelled backend or fill
    policy would otherwise silently fall through a default branch), and
    malformed phase schedules (a gapped or late-starting schedule would
    otherwise silently train early epochs at the wrong resolution)."""
    for dotted, allowed in _VALID.items():
        section, field = dotted.split(".")
        val = getattr(getattr(cfg, section), field)
        if val not in allowed:
            raise ValueError(
                f"config {dotted}={val!r} not in {sorted(allowed)}"
            )
    if not cfg.phases:
        raise ValueError("config has no training phases")
    if cfg.phases[0].start_epoch != 0:
        raise ValueError(
            f"first phase starts at epoch {cfg.phases[0].start_epoch}; "
            "phase schedules must start at 0"
        )
    for prev, nxt in zip(cfg.phases, cfg.phases[1:]):
        if prev.end_epoch != nxt.start_epoch:
            raise ValueError(
                f"phase schedule not contiguous: phase ending at "
                f"{prev.end_epoch} followed by one starting at "
                f"{nxt.start_epoch}"
            )
    for p in cfg.phases:
        if p.end_epoch <= p.start_epoch:
            raise ValueError(
                f"phase [{p.start_epoch}, {p.end_epoch}) is empty"
            )
    return cfg


def load_config(path: str) -> Config:
    from nerf_fewshot_tpu_torch.utils.yaml_subset import safe_load

    with open(path) as f:
        return validate_config(config_from_dict(safe_load(f.read())))
