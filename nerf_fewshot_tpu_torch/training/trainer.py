"""The training engine on one device (counterpart of
``nerf_fewshot_tpu/training/trainer.py:Trainer``).

Each step gathers a minibatch of packed ``[o|d|rgb]`` rows, draws the
stratified-jitter uniforms (and, with ``rendering.n_importance``, the
importance uniforms) from the trainer's ``torch.Generator`` and takes one
optimizer step. On the kernel path the loss and every gradient come from
``fused_train_loss_grad``, which launches the CUDA training kernel on a
card and runs its plain version on the CPU; the plain path is
``render_rays`` + ``nerf_loss`` + autograd. Which path a config takes
follows the JAX trainer: ``rendering.backend: xla``, or under ``auto`` a
config the JAX kernels do not take (``arch: module``, skip layers, a width
that is not a multiple of 128, sigma noise), trains on the plain path on
every device. A config the JAX kernels take but the port has no CUDA build
for (a width of 384 or 512, an MLP input wider than 896 columns) raises on
a card, and trains on the plain path only on the CPU or with ``backend:
xla``. The path taken is in ``kernel_path``. Minibatch
permutations come from ``np.random.default_rng(cfg.seed)`` exactly as in
the JAX trainer, so both draw the same batches. Eval renders every view
through ``fused_render_rays(forward_only=True)`` on the kernel path.

DINO conditioning takes the per-view feature maps ``dino_features``
(V, Hp, Wp, Fd), computed once before training and held constant (no
gradient reaches them, as in the reference). Each step's points are
projected into its view and sampled from that view's map
(``feature_sampler``); eval and the dead-sigma probe use train view 0's
map and pose for every pose, the reference's quirk. On the kernel path the
features enter kernel 1 and kernel 2 as their ``feats`` input.

``arch: module`` trains ``NeRFWithDINO`` on the plain path. Trunk LoRA
(``nerf_model.lora_rank``) runs through the kernels with the LoRA pairs
merged into the trunk weights (``pack_params``), and
``optimizer.lora_only_after_epoch`` swaps in a fresh optimizer over the
LoRA parameters alone at that epoch, once (the two-phase freeze).
``load`` of a ``.pth`` / ``.pt`` file imports a reference PyTorch
checkpoint (``load_torch``), of a JAX package ``.ckpt`` (flax msgpack) its
params and Adam state (``load_jax_checkpoint``). ``evaluate`` returns the
JAX trainer's metric triple: PSNR, SSIM and LPIPS(VGG) with its provenance.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device
from nerf_fewshot_tpu_torch.models.mlp import (
    NeRFMLP,
    NeRFWithDINO,
    nerf_mlp_from_jax,
    nerf_with_dino_from_jax,
)
from nerf_fewshot_tpu_torch.ops.composite import RenderOutputs
from nerf_fewshot_tpu_torch.ops.interp import grid_sample
from nerf_fewshot_tpu_torch.ops.rays import (
    get_rays,
    project_points_script,
    project_points_to_image,
)
from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
from nerf_fewshot_tpu_torch.render.kernels import (
    KERNEL_WIDTHS,
    MAX_INPUT_WIDTH,
    pe_layout,
    pe_width,
)
from nerf_fewshot_tpu_torch.render.pipeline import PointFeaturesFn, RenderSettings, render_rays
from nerf_fewshot_tpu_torch.render.train_kernel import fused_train_loss_grad
from nerf_fewshot_tpu_torch.training.config import Config
from nerf_fewshot_tpu_torch.training.losses import nerf_loss
from nerf_fewshot_tpu_torch.training.metrics import LPIPSMetric, psnr, ssim
from nerf_fewshot_tpu_torch.training.optim import make_optimizer, multistep_lr, set_learning_rate
from nerf_fewshot_tpu_torch.utils.checkpoint import (
    checkpoint_format,
    restore_checkpoint,
    restore_msgpack_checkpoint,
    save_checkpoint,
)
from nerf_fewshot_tpu_torch.utils.logging import JSONLLogger, save_png
from nerf_fewshot_tpu_torch.utils.profiling import RateMeter
from nerf_fewshot_tpu_torch.utils.torch_import import (
    import_nerf_mlp_state_dict,
    import_nerf_with_dino_state_dict,
    load_torch_checkpoint,
    model_state_dict,
)

ChunkFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _feature_sampler(feat_map: torch.Tensor, pose: torch.Tensor, focal: float, H: int, W: int,
                     align_corners: bool = False, invalid_fill: str = "zeros",
                     projection: str = "reference") -> PointFeaturesFn:
    """Per-point conditioning: project (N, 3) points into the view of
    ``pose`` and sample ``feat_map`` (Hp, Wp, Fd) there bilinearly.
    ``projection='reference'`` is the proper-inverse projection with its
    validity mask, ``'script'`` the standalone scripts' forward-rotation one
    (no mask). ``invalid_fill='mean'`` replaces the features of invalid
    projections by the mean over all sampled features, the zero-filled
    invalid ones included: the multiscale trainer's quirk, reproduced."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        if projection == "script":
            pts2d, _ = project_points_script(pts, pose, focal, H, W)
            return grid_sample(feat_map, pts2d, align_corners=align_corners)
        pts2d, _, valid = project_points_to_image(pts, pose, focal, H, W)
        f = grid_sample(feat_map, pts2d, align_corners=align_corners)
        if invalid_fill == "mean":
            f = torch.where(valid[:, None], f, torch.mean(f, dim=0, keepdim=True))
        return f

    return fn


@dataclasses.dataclass
class PhaseData:
    """Per-phase, per-view ray data on the trainer's device."""

    rays_o: torch.Tensor  # (V, HW, 3)
    rays_d: torch.Tensor  # (V, HW, 3)
    targets: torch.Tensor  # (V, HW, 3)
    H: int
    W: int


class Trainer:
    """Few-shot NeRF trainer on one device (``cuda`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(
        self,
        cfg: Config,
        train_data: BlenderDataset,
        test_data: Optional[BlenderDataset] = None,
        device: DeviceLike = None,
        log_path: Optional[str] = None,
        dino_features: Optional[np.ndarray] = None,  # (V, Hp, Wp, Fd)
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_data = train_data
        self.test_data = test_data
        self.H, self.W, self.focal = train_data.H, train_data.W, train_data.focal
        self.targets_full = np.asarray(train_data.white_composited(), np.float32)  # (V,H,W,3)
        self.poses = np.asarray(train_data.poses, np.float32)
        self.n_views = train_data.n_views
        self._poses_t = torch.as_tensor(self.poses, device=self.device)
        # as the JAX trainer: conditioning needs the config's flag and the maps
        self.use_dino = cfg.dino.use_dino and dino_features is not None
        self.dino_features = (
            torch.as_tensor(np.asarray(dino_features, np.float32), device=self.device)
            if self.use_dino else None)

        generator = torch.Generator().manual_seed(cfg.seed)
        n = cfg.nerf
        if n.arch == "module":
            self.model = NeRFWithDINO(
                pos_freq=n.pos_freq, dir_freq=n.dir_freq, dino_dim=cfg.dino.output_dim,
                hidden_dim=n.hidden_dim, num_density_layers=n.num_layers, generator=generator,
            ).to(self.device)
        else:
            self.model = NeRFMLP(
                pos_freq=n.pos_freq,
                dir_freq=n.dir_freq,
                use_viewdirs=n.use_viewdirs,
                dino_dim=cfg.dino.output_dim if self.use_dino else 0,
                hidden_dim=n.hidden_dim,
                num_layers=n.num_layers,
                skip_layers=tuple(n.skip_layers),
                lora_rank=n.lora_rank,
                lora_alpha=n.lora_alpha,
                sigma_bias_init=n.sigma_bias,
                generator=generator,
            ).to(self.device)

        self.lr_at = multistep_lr(
            cfg.optimizer.lr, cfg.optimizer.lr_milestones, cfg.optimizer.lr_gamma
        )
        self.optimizer = make_optimizer(cfg.optimizer, self.model.named_parameters())
        # the two-phase freeze has swapped in the LoRA-only optimizer
        self._lora_only_active = False
        self.epoch = 0
        self.best_psnr = 0.0
        # consecutive epochs the dead-sigma probe reported acc == 0
        self.dead_sigma_epochs = 0
        # "kernel" or "plain" and why, set by every choice of the path
        self.kernel_path: Optional[str] = None
        self.kernel_path_reason: Optional[str] = None
        self.last_step_losses = np.zeros(0)  # per-step losses of the last epoch
        self._phase_data: Dict[int, PhaseData] = {}
        self._np_rng = np.random.default_rng(cfg.seed)
        # stratified-jitter uniforms; torch's stream, not JAX's threefry
        self._generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.logger = JSONLLogger(
            path=log_path, run_name=cfg.name, config=cfg.raw,
            use_wandb=cfg.output.use_wandb, wandb_project=cfg.output.wandb_project,
        )
        self.lpips = LPIPSMetric(self.device)
        # seconds of the last evaluate(): the render and the LPIPS leg apart
        self.eval_seconds: Dict[str, float] = {}
        self.rate_meter = RateMeter()

    # ------------------------------------------------------------------ model

    def load_jax_params(self, params: Mapping) -> None:
        """Take the weights of a JAX param tree (numpy leaves) of the
        configured architecture: ``NeRFMLP`` (with or without its DINO input
        rows, dense or LoRA trunk) or ``NeRFWithDINO``."""
        from_jax = nerf_with_dino_from_jax if self.cfg.nerf.arch == "module" else nerf_mlp_from_jax
        self.model.load_state_dict(from_jax(params))

    def feature_sampler(self, view: int) -> Optional[PointFeaturesFn]:
        """Train view ``view``'s conditioning closure (``_feature_sampler``
        with the DINO config's conventions and the full-resolution
        intrinsics), or None without conditioning."""
        if not self.use_dino:
            return None
        d = self.cfg.dino
        return _feature_sampler(
            self.dino_features[view], self._poses_t[view], self.focal, self.H, self.W,
            align_corners=d.align_corners, invalid_fill=d.invalid_fill, projection=d.projection)

    def _jax_ineligible_reason(self) -> Optional[str]:
        """Why the JAX package's kernels would not take this config (its
        ``Trainer._kernel_ineligible_reason``, word for word)."""
        cfg = self.cfg
        if cfg.nerf.arch == "module":
            return "arch=module (NeRFWithDINO) has no kernel packing"
        if cfg.nerf.skip_layers:
            return (
                f"skip_layers={list(cfg.nerf.skip_layers)} — the fused "
                "kernels require a uniform trunk (pack_params assumes "
                "hidden→hidden layers)"
            )
        if cfg.nerf.hidden_dim % 128 != 0:
            return f"hidden_dim={cfg.nerf.hidden_dim} not 128-lane aligned"
        if not (cfg.strict_reference_behavior or cfg.rendering.noise_std == 0.0):
            return "sigma noise_std != 0 is not implemented in the kernels"
        return None

    def _port_gap_reason(self) -> Optional[str]:
        """Why the port's kernels cannot take a config the JAX kernels take."""
        n = self.cfg.nerf
        if n.hidden_dim not in KERNEL_WIDTHS:
            return (f"hidden_dim={n.hidden_dim} has no CUDA build "
                    f"(the kernels are built for {KERNEL_WIDTHS})")
        feat_dim = self.cfg.dino.output_dim if self.use_dino else 0
        x_dim = pe_layout(n.pos_freq, n.dir_freq, n.use_viewdirs, feat_dim)[3]
        if pe_width(x_dim) > MAX_INPUT_WIDTH:
            return (f"the MLP input is {x_dim} wide; the CUDA kernels take at most "
                    f"{MAX_INPUT_WIDTH}")
        return None

    def _use_fused(self) -> bool:
        """Whether training steps and renders go through the kernels
        (``fused_train_loss_grad``, ``fused_render_rays``): the CUDA kernels
        on a card, their plain versions on the CPU. Records the choice in
        ``kernel_path`` ("kernel" or "plain") and ``kernel_path_reason``.

        ``backend: xla`` takes the plain path. A config the JAX kernels do
        not take takes it too under ``auto``, on every device, as the JAX
        trainer does, and raises under ``fused``. A config only the port's
        kernels cannot take raises under ``fused``, and on a card under
        ``auto``: the JAX package would run its kernel there."""
        backend = self.cfg.rendering.backend
        where = self.device.type
        jax_reason, gap = self._jax_ineligible_reason(), self._port_gap_reason()
        if backend == "xla":
            reason = "rendering.backend: xla"
        elif jax_reason is not None:
            if backend == "fused":
                raise ValueError(f"rendering.backend=fused rejected on {where}: {jax_reason}")
            reason = jax_reason
        elif gap is not None:
            if backend == "fused" or where != "cpu":
                raise ValueError(
                    f"rendering.backend={backend} rejected on {where}: {gap} "
                    f"(backend: xla trains and renders on the plain path)")
            reason = gap
        else:
            reason = None
        self.kernel_path = "kernel" if reason is None else "plain"
        self.kernel_path_reason = reason
        return reason is None

    def _ray_render_fn(self, settings: RenderSettings, forward_only: bool = False,
                       pf: Optional[PointFeaturesFn] = None):
        """``(rays_o, rays_d, uniforms=None, importance_uniforms=None) ->
        RenderOutputs`` on the configured path, conditioned on ``pf``'s
        features. ``forward_only``: the eval render, under no-grad (the
        inline-PE forward kernel on the kernel path); otherwise
        differentiable in the model's parameters (the fused ``fused_render``
        on the kernel path, autograd on the plain one)."""
        cfg = self.cfg
        if self._use_fused():
            params = (self.model.state_dict() if forward_only
                      else dict(self.model.named_parameters()))

            def fn(ro, rd, uniforms=None, importance_uniforms=None) -> RenderOutputs:
                return fused_render_rays(
                    params, ro, rd, settings,
                    pos_freq=cfg.nerf.pos_freq, dir_freq=cfg.nerf.dir_freq,
                    num_layers=cfg.nerf.num_layers, hidden_dim=cfg.nerf.hidden_dim,
                    use_viewdirs=cfg.nerf.use_viewdirs,
                    compute_dtype=cfg.rendering.compute_dtype,
                    forward_only=forward_only, device=self.device,
                    uniforms=uniforms, importance_uniforms=importance_uniforms,
                    point_features_fn=pf, lora_alpha=cfg.nerf.lora_alpha,
                )

            return fn

        def fn(ro, rd, uniforms=None, importance_uniforms=None) -> RenderOutputs:
            with torch.set_grad_enabled(torch.is_grad_enabled() and not forward_only):
                return render_rays(self.model, ro, rd, settings, uniforms, importance_uniforms,
                                   point_features_fn=pf)

        return fn

    def _render_settings(self, n_samples: int, training: bool) -> RenderSettings:
        cfg = self.cfg
        noise = 0.0
        if training and not cfg.strict_reference_behavior:
            noise = cfg.rendering.noise_std
        r = cfg.rendering
        return RenderSettings(
            near=r.near, far=r.far, n_samples=n_samples, n_importance=r.n_importance,
            perturb=training, noise_std=noise, white_bkgd=r.white_bkgd, lindisp=r.lindisp,
        )

    # ------------------------------------------------------------- phase data

    def phase_data(self, phase_idx: int) -> PhaseData:
        """Per-phase rays and targets of every train view, on the device:
        focal scaled with the phase resolution when ``cfg.focal_scaling``,
        targets resized bilinearly (torch semantics, ``align_corners=False``)."""
        if phase_idx in self._phase_data:
            return self._phase_data[phase_idx]
        p = self.cfg.phases[phase_idx]
        Hp, Wp = p.H, p.W
        focal = self.focal * (Hp / self.H) if self.cfg.focal_scaling else self.focal
        ros, rds, tgts = [], [], []
        for v in range(self.n_views):
            ro, rd = get_rays(Hp, Wp, focal, torch.as_tensor(self.poses[v], device=self.device))
            tgt = torch.as_tensor(self.targets_full[v], device=self.device)
            if (Hp, Wp) != (self.H, self.W):
                tgt = F.interpolate(tgt.permute(2, 0, 1)[None], size=(Hp, Wp), mode="bilinear",
                                    align_corners=False)[0].permute(1, 2, 0)
            ros.append(ro.reshape(-1, 3))
            rds.append(rd.reshape(-1, 3))
            tgts.append(tgt.reshape(-1, 3))
        pd = PhaseData(rays_o=torch.stack(ros), rays_d=torch.stack(rds),
                       targets=torch.stack(tgts).contiguous(), H=Hp, W=Wp)
        self._phase_data[phase_idx] = pd
        return pd

    def _phase_index(self, epoch: int) -> int:
        for i, p in enumerate(self.cfg.phases):
            if p.start_epoch <= epoch < p.end_epoch:
                return i
        if self.cfg.phases and epoch < self.cfg.phases[0].start_epoch:
            raise ValueError(
                f"epoch {epoch} precedes the first phase "
                f"(starts at {self.cfg.phases[0].start_epoch})"
            )
        return len(self.cfg.phases) - 1

    # ------------------------------------------------------------- train step

    def _kernel_loss_grad(self, ro, rd, tgt, mask, settings, uniforms,
                          importance_uniforms, pf=None) -> torch.Tensor:
        """One step's loss; its gradients land in the parameters' ``.grad``."""
        cfg = self.cfg
        loss, grads = fused_train_loss_grad(
            self.model, ro, rd, tgt, mask, settings,
            pos_freq=cfg.nerf.pos_freq, dir_freq=cfg.nerf.dir_freq,
            num_layers=cfg.nerf.num_layers, hidden_dim=cfg.nerf.hidden_dim,
            use_viewdirs=cfg.nerf.use_viewdirs, compute_dtype=cfg.rendering.compute_dtype,
            uniforms=uniforms, importance_uniforms=importance_uniforms,
            point_features_fn=pf, rgb_weight=float(cfg.loss.rgb_weight),
            reg_weight=0.0 if cfg.strict_reference_behavior else float(cfg.loss.reg_weight),
            lora_alpha=cfg.nerf.lora_alpha,
        )
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        return loss

    def _plain_loss_grad(self, ro, rd, tgt, mask, settings, uniforms,
                         importance_uniforms, pf=None) -> torch.Tensor:
        cfg = self.cfg
        out = self._ray_render_fn(settings, pf=pf)(ro, rd, uniforms, importance_uniforms)
        losses = nerf_loss(
            out.rgb, tgt, cfg.loss,
            weights=None if cfg.strict_reference_behavior else out.weights, mask=mask,
        )
        self.model.zero_grad(set_to_none=True)
        losses["total"].backward()
        return losses["total"].detach()

    def train_epoch(self, epoch: int) -> float:
        """One epoch over all views: a fresh permutation per view, the
        ragged tail padded with index 0 and mask 0, one optimizer step per
        minibatch. Returns the mean step loss."""
        cfg = self.cfg
        phase_idx = self._phase_index(epoch)
        p = cfg.phases[phase_idx]
        pd = self.phase_data(phase_idx)
        boundary = cfg.optimizer.lora_only_after_epoch
        if boundary and epoch >= boundary and not self._lora_only_active:
            # the two-phase freeze (JAX trainer.py:567-575): a fresh
            # optimizer over the LoRA parameters alone, once
            self.optimizer = make_optimizer(cfg.optimizer, self.model.named_parameters(),
                                            lora_only=True)
            self._lora_only_active = True
        set_learning_rate(self.optimizer, self.lr_at(epoch))

        n_rays = pd.rays_o.shape[1]
        B = min(p.batch_size, n_rays)
        n_batches = (n_rays + B - 1) // B
        V = self.n_views
        pad_total = n_batches * B - n_rays
        idxs = np.empty((V, n_batches, B), np.int64)
        masks = np.ones((V, n_batches * B), np.float32)
        for v in range(V):
            perm = self._np_rng.permutation(n_rays)
            idxs[v] = np.concatenate([perm, np.zeros(pad_total, perm.dtype)]).reshape(n_batches, B)
            if pad_total:
                masks[v, n_rays:] = 0.0
        idxs_t = torch.as_tensor(idxs, device=self.device)
        masks_t = torch.as_tensor(masks.reshape(V, n_batches, B), device=self.device)

        settings = self._render_settings(p.n_samples, training=True)
        step = self._kernel_loss_grad if self._use_fused() else self._plain_loss_grad
        losses = []
        for v in range(V):
            pf = self.feature_sampler(v)  # the view's map and pose (JAX trainer.py:608-613)
            view_packed = torch.cat([pd.rays_o[v], pd.rays_d[v], pd.targets[v]], dim=1)
            for b in range(n_batches):
                row = view_packed[idxs_t[v, b]]
                uniforms = importance = None
                if settings.perturb:
                    uniforms = torch.rand((B, p.n_samples), generator=self._generator,
                                          device=self.device)
                    if settings.n_importance > 0:
                        importance = torch.rand((B, settings.n_importance),
                                                generator=self._generator, device=self.device)
                losses.append(step(row[:, 0:3], row[:, 3:6], row[:, 6:9], masks_t[v, b],
                                   settings, uniforms, importance, pf))
                self.optimizer.step()
        self.last_step_losses = torch.stack(losses).cpu().numpy()
        return float(np.mean(self.last_step_losses))

    # ------------------------------------------------------------- health

    def dead_sigma_probe(self) -> float:
        """Max accumulated alpha over one chunk of train-view-0 rays. Exactly
        0.0 means relu(sigma) is zero at every sampled point: compositing
        then has exactly zero gradient and training cannot recover."""
        chunk_size = self.cfg.rendering.chunk_size
        fn = self._eval_chunk_fn(self.cfg.phases[-1].n_samples)
        pd = self.phase_data(self._phase_index(self.epoch))
        ro, rd = pd.rays_o[0], pd.rays_d[0]
        if ro.shape[0] >= chunk_size:
            ro, rd = ro[:chunk_size], rd[:chunk_size]
        else:
            reps = -(-chunk_size // ro.shape[0])
            ro = ro.repeat(reps, 1)[:chunk_size]
            rd = rd.repeat(reps, 1)[:chunk_size]
        _, _, acc = fn(ro, rd)
        return float(torch.max(acc))

    # ------------------------------------------------------------------- eval

    def _eval_chunk_fn(self, n_samples: int) -> ChunkFn:
        """Per-chunk eval renderer: (ro, rd) -> (rgb, depth, acc), conditioned
        on train view 0's features whatever the pose (the reference's eval
        quirk)."""
        render = self._ray_render_fn(self._render_settings(n_samples, training=False),
                                     forward_only=True, pf=self.feature_sampler(0))

        def chunk(ro, rd):
            out = render(ro, rd)
            return out.rgb, out.depth, out.acc

        return chunk

    def render_view(self, pose, n_samples: Optional[int] = None):
        """Full-image render of one pose: (rgb, depth, acc) numpy arrays."""
        rgb, depth, acc = self.render_views([pose], n_samples)
        return rgb[0], depth[0], acc[0]

    def render_views(
        self, poses: Sequence, n_samples: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Render every pose's rays as one stream of fixed-size chunks (the
        last padded with copies of the last ray). Returns (V, H, W[, 3])
        rgb, depth and acc numpy arrays."""
        cfg = self.cfg
        if n_samples is None:
            n_samples = cfg.phases[-1].n_samples
        chunk_size = cfg.rendering.chunk_size
        fn = self._eval_chunk_fn(n_samples)
        ros, rds = [], []
        for pose in poses:
            ro, rd = get_rays(
                self.H, self.W, self.focal,
                torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device),
            )
            ros.append(ro.reshape(-1, 3))
            rds.append(rd.reshape(-1, 3))
        ro = torch.cat(ros)
        rd = torch.cat(rds)
        V, n = len(poses), ro.shape[0]
        pad = (-n) % chunk_size
        if pad:
            ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
        outs = [fn(ro[i:i + chunk_size], rd[i:i + chunk_size])
                for i in range(0, ro.shape[0], chunk_size)]
        rgb = torch.cat([o[0] for o in outs])[:n].reshape(V, self.H, self.W, 3)
        depth = torch.cat([o[1] for o in outs])[:n].reshape(V, self.H, self.W)
        acc = torch.cat([o[2] for o in outs])[:n].reshape(V, self.H, self.W)
        return rgb.cpu().numpy(), depth.cpu().numpy(), acc.cpu().numpy()

    def evaluate(self, max_views: Optional[int] = None, dump_dir: Optional[str] = None) -> Dict[str, Any]:
        """Full-resolution eval on the test split: mean PSNR, SSIM and LPIPS,
        with ``lpips_pretrained`` and ``lpips_backend`` saying which LPIPS
        ran; with ``dump_dir``, the first five views' renders and targets as
        PNGs. ``eval_seconds`` keeps the render's and the LPIPS leg's
        seconds."""
        if self.test_data is None:
            return {}
        n = self.test_data.n_views if max_views is None else min(max_views, self.test_data.n_views)
        targets = self.test_data.white_composited()
        t0 = time.perf_counter()
        rendered, _, _ = self.render_views([self.test_data.poses[i] for i in range(n)])
        t_render = time.perf_counter() - t0
        all_psnr, all_ssim, all_lpips, t_lpips = [], [], [], 0.0
        for i in range(n):
            pred = torch.as_tensor(rendered[i], device=self.device)
            tgt = torch.as_tensor(np.asarray(targets[i], np.float32), device=self.device)
            all_psnr.append(float(psnr(pred, tgt)))
            all_ssim.append(float(ssim(pred, tgt)))
            t1 = time.perf_counter()
            all_lpips.append(self.lpips(pred, tgt))  # a float: synchronized
            t_lpips += time.perf_counter() - t1
            if dump_dir is not None and i < 5:
                save_png(os.path.join(dump_dir, f"render_{i}.png"), np.clip(rendered[i], 0, 1))
                save_png(os.path.join(dump_dir, f"gt_{i}.png"), np.asarray(targets[i]))
        self.eval_seconds = {"views": n, "render": t_render, "lpips": t_lpips}
        return {"psnr": float(np.mean(all_psnr)), "ssim": float(np.mean(all_ssim)),
                "lpips": float(np.mean(all_lpips)),
                # a random-VGG LPIPS is a valid distance on another scale than
                # the reference's pretrained-VGG numbers: say which one ran
                "lpips_pretrained": bool(self.lpips.pretrained),
                "lpips_backend": str(self.lpips.backend)}

    # ------------------------------------------------------------------ train

    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        """Train from ``self.epoch`` to ``epochs`` (default ``cfg.epochs``):
        rays/s, the loss and ``kernel_path`` in the log every epoch, the
        dead-sigma probe, eval with image dumps and ``best.ckpt`` every
        ``val_freq`` epochs, ``epoch_N.ckpt`` every ``save_freq``. Returns
        the last eval's metrics with ``kernel_path`` and its reason."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        metrics: Dict[str, float] = {}
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            t0 = time.perf_counter()
            loss = self.train_epoch(epoch)  # syncs on its losses: the time is real
            pd = self.phase_data(self._phase_index(epoch))
            rate = self.rate_meter.update(
                self.n_views * pd.rays_o.shape[1], time.perf_counter() - t0
            )
            self.logger.log({"epoch": epoch, "train_loss": loss, "lr": self.lr_at(epoch),
                             "rays_per_sec": rate, "kernel_path": self.kernel_path,
                             "kernel_path_reason": self.kernel_path_reason})
            if self.dead_sigma_probe() <= 0.0:
                self.dead_sigma_epochs += 1
                print(
                    f"[DEAD-SIGMA] epoch {epoch}: accumulated alpha is exactly 0 over the "
                    f"probe chunk — relu(sigma) is zero at every sampled point, gradients "
                    f"are exactly zero and training cannot recover "
                    f"({self.dead_sigma_epochs} consecutive epoch(s)). Consider "
                    f"nerf_model.sigma_bias: 0.1 or a different seed."
                )
                self.logger.log({"epoch": epoch, "dead_sigma": True,
                                 "dead_sigma_epochs": self.dead_sigma_epochs})
            else:
                self.dead_sigma_epochs = 0
            if (epoch + 1) % cfg.output.val_freq == 0:
                dump = os.path.join(cfg.output.save_dir, f"epoch_{epoch}")
                metrics = self.evaluate(dump_dir=dump)
                self.logger.log({"epoch": epoch, **metrics})
                if metrics.get("psnr", 0.0) > self.best_psnr:
                    self.best_psnr = metrics["psnr"]
                    self.save(os.path.join(cfg.output.save_dir, "best.ckpt"))
            if (epoch + 1) % cfg.output.save_freq == 0:
                self.save(os.path.join(cfg.output.save_dir, f"epoch_{epoch + 1}.ckpt"))
        return {**metrics, "kernel_path": self.kernel_path,
                "kernel_path_reason": self.kernel_path_reason}

    # ------------------------------------------------------------- checkpoint

    def save(self, path: str) -> None:
        save_checkpoint(
            path,
            {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
             "lora_only": self._lora_only_active},
            metadata={"epoch": self.epoch, "best_psnr": self.best_psnr, "config": self.cfg.raw},
        )

    def _check_freeze_side(self, path: str, saved_lora_only: bool) -> None:
        """An optimizer state from one side of the two-phase freeze does not
        load into a trainer on the other side: the JAX trainer's restore
        fails there too (the LoRA-only state has another structure)."""
        if saved_lora_only != self._lora_only_active:
            side = lambda lora_only: "LoRA-only" if lora_only else "full"
            raise ValueError(
                f"{path} holds the {side(saved_lora_only)} optimizer state of one side of the "
                f"two-phase freeze (optimizer.lora_only_after_epoch="
                f"{self.cfg.optimizer.lora_only_after_epoch}); this trainer's optimizer is the "
                f"{side(self._lora_only_active)} one. The JAX trainer cannot resume across the "
                f"freeze either; resume from a checkpoint saved on this trainer's side of it")

    def _restore_meta(self, meta: Optional[Dict]) -> None:
        if meta:
            self.epoch = int(meta.get("epoch", 0)) + 1
            self.best_psnr = float(meta.get("best_psnr", 0.0))

    def load(self, path: str) -> None:
        """Restore the model, the optimizer state and (from the metadata)
        the next epoch and the best PSNR. A ``.pth`` / ``.pt`` path is a
        reference PyTorch checkpoint (``load_torch``); any other is told by
        its first bytes: the port's ``torch.save`` zip or a JAX package
        msgpack checkpoint (``load_jax_checkpoint``). Either raises when its
        optimizer state is from the other side of the two-phase freeze."""
        if path.endswith((".pth", ".pt")):
            self.load_torch(path)
            return
        if checkpoint_format(path) == "msgpack":
            self.load_jax_checkpoint(path)
            return
        tree, meta = restore_checkpoint(path, map_location=self.device)
        self._check_freeze_side(path, bool(tree.get("lora_only", False)))
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self._restore_meta(meta)

    def load_jax_checkpoint(self, path: str) -> None:
        """Load a JAX package checkpoint (``Trainer.save`` there: flax
        msgpack of ``{params, opt_state}``, the JSON sidecar): the params
        through ``load_jax_params``, the Adam state into this trainer's
        optimizer, the epoch and best PSNR from the sidecar.

        The optimizer state is the JAX ``make_optimizer`` chain:
        ``inject_hyperparams`` (``count``, ``hyperparams/learning_rate``)
        around a chain holding one ``scale_by_adam`` state (``count``,
        ``mu``, ``nu``), or after the freeze that chain under
        ``multi_transform``'s ``lora`` mask (masked leaves stored as empty
        maps). A state of another layout raises and names it: the optimizer
        is never re-initialized in its place."""
        tree, meta = restore_msgpack_checkpoint(path)
        opt = tree.get("opt_state")
        lora_only = isinstance(opt, dict) and "inner_states" in opt
        self._check_freeze_side(path, lora_only)
        inject = opt["inner_states"]["lora"]["inner_state"] if lora_only else opt
        chain = inject.get("inner_state") if isinstance(inject, dict) else None
        adam = [s for s in chain.values() if isinstance(s, dict) and {"count", "mu", "nu"} <= set(s)
                ] if isinstance(chain, dict) else []
        if len(adam) != 1 or "learning_rate" not in inject.get("hyperparams", {}):
            raise ValueError(
                f"{path}: its opt_state is not the JAX make_optimizer chain the port maps "
                f"(inject_hyperparams around one scale_by_adam state, optionally under the "
                f"lora_only multi_transform); top-level keys "
                f"{sorted(opt) if isinstance(opt, dict) else type(opt).__name__}")
        params = tree["params"]
        self.load_jax_params(params)

        def unmasked(moment, like):  # masked leaves are empty maps: zeros of the param
            if isinstance(like, dict):
                return {k: unmasked(moment.get(k, {}), v) for k, v in like.items()}
            return moment if isinstance(moment, np.ndarray) else np.zeros_like(like)

        from_jax = nerf_with_dino_from_jax if self.cfg.nerf.arch == "module" else nerf_mlp_from_jax
        mu = from_jax(unmasked(adam[0]["mu"], params))
        nu = from_jax(unmasked(adam[0]["nu"], params))
        names = {id(p): n for n, p in self.model.named_parameters()}
        sd = self.optimizer.state_dict()
        step = float(np.asarray(adam[0]["count"]))
        sd["state"] = {}
        for i, p in enumerate(self.optimizer.param_groups[0]["params"]):
            n = names[id(p)]
            sd["state"][i] = {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for g in sd["param_groups"]:
            g["lr"] = float(np.asarray(inject["hyperparams"]["learning_rate"]))
        self.optimizer.load_state_dict(sd)
        self._restore_meta(meta)

    def load_torch(self, path: str) -> None:
        """Import a reference PyTorch checkpoint: the NeRF state dict under
        ``nerf_model_state_dict``, ``nerf_state_dict`` or bare, mapped by
        ``utils/torch_import.py``; entries it does not match keep their
        values. The optimizer starts afresh (of the kind this trainer holds
        now), and the epoch follows the file's ``epoch`` + 1 when it has
        one."""
        ckpt = load_torch_checkpoint(path)
        sd = model_state_dict(ckpt)
        importer = (import_nerf_with_dino_state_dict if self.cfg.nerf.arch == "module"
                    else import_nerf_mlp_state_dict)
        self.model.load_state_dict(importer(self.model.state_dict(), sd))
        self.optimizer = make_optimizer(self.cfg.optimizer, self.model.named_parameters(),
                                        lora_only=self._lora_only_active)
        if isinstance(ckpt, dict) and "epoch" in ckpt:
            try:
                self.epoch = int(ckpt["epoch"]) + 1
            except (TypeError, ValueError):
                pass
