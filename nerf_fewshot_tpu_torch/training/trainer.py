"""The training engine, on one device or data parallel (counterpart of
``nerf_fewshot_tpu/training/trainer.py:Trainer``).

Each step gathers a minibatch of packed ``[o|d|rgb]`` rows, draws the
stratified-jitter uniforms (and, with ``rendering.n_importance``, the
importance uniforms) from the trainer's ``torch.Generator`` and takes one
optimizer step. On the kernel path the loss and every gradient come from
``fused_train_loss_grad``, which launches the CUDA training kernel on a
card and runs its plain version on the CPU; the plain path is
``render_rays`` + ``nerf_loss`` + autograd, with sigma noise (normals from
the same generator) when training outside the strict reference behavior
with ``rendering.noise_std``. Which path a config takes
follows the JAX trainer: ``rendering.backend: xla``, or under ``auto`` a
config the JAX kernels do not take (``arch: module``, skip layers, a width
that is not a multiple of 128, sigma noise), trains on the plain path on
every device; every config the JAX kernels take (any trunk width that is a
multiple of 128, any input width, samples per ray and depth) takes the
kernels. The path taken is in ``kernel_path``. Minibatch permutations come from ``np.random.default_rng(cfg.seed)`` exactly as in
the JAX trainer, so both draw the same batches. Eval renders every view
through ``fused_render_rays(forward_only=True)`` on the kernel path.

DINO conditioning takes the per-view feature maps ``dino_features``
(V, Hp, Wp, Fd), computed once before training and held constant (no
gradient reaches them, as in the reference). Each step's points are
projected into its view and sampled from that view's map
(``feature_sampler``); eval and the dead-sigma probe use train view 0's
map and pose for every pose, the reference's quirk. On the kernel path the
features enter kernel 1 and kernel 2 as their ``feats`` input; on a card
they are sampled there by one launch of ``csrc/point_features.cu``
(``render/point_features.py``) over the map stack and the per-view
world-to-camera stack ``_w2c_t``, inverted once at construction; the plain
path and the CPU keep the plain sampler.

Under a data-parallel ``mesh`` (``parallel/mesh.py``), every rank holds
the model, draws the same permutations and uniforms and takes a contiguous
block of each minibatch's rows (the batch padded to a multiple of the world
size); the step's masked means divide by the batch's valid-ray count, and
the loss and gradients are summed over the ranks before the optimizer
step, so every rank takes the same step: the kernel path through
``parallel/fused_dp.make_dp_fused_loss_grad`` (the count from the whole
batch's mask, which every rank holds; the gradients and the loss summed by
one in-place all-reduce of the ``.grad`` buffer with the loss beside it),
the plain path through autograd and one all-reduce. Eval and the
dead-sigma probe render on each rank alone.

On a card the kernel path's steps run as a CUDA graph
(``training/step_graph.py``): each phase's step body is captured once and
replayed once per minibatch, its Adam step one launch of ``csrc/adam.cu``
(``AdamKernel``), bit-equal to the eager step. Under an NCCL mesh each rank
captures its own body, the all-reduce inside it; a Gloo mesh's collectives
run on the host and cannot be captured. ``step_mode`` says "graph" or
"eager" and ``step_mode_reason`` why a trainer steps eagerly: the plain
path, a Gloo mesh, the CPU, or ``Trainer(_eager_step=True)``, the card's
eager step kept for the gates that hold the graph to it. Every trainer
writes the step's gradients into contiguous ``.grad`` buffers allocated
once (``grad_buffer``) and clips them, when the config clips, before the
step with the norm summed over the gradients as the kernel gave them (under
a mesh: as the all-reduce summed them, in the buffers).

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
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

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
    phase_rays,
    project_points_script,
    project_points_to_image,
)
from nerf_fewshot_tpu_torch.parallel.fused_dp import make_dp_fused_loss_grad
from nerf_fewshot_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    can_capture,
    process_local_slice,
)
from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
from nerf_fewshot_tpu_torch.render.kernels import pack_params, pe_constants, pe_width, to_device
from nerf_fewshot_tpu_torch.render.pipeline import PointFeaturesFn, RenderSettings, render_rays
from nerf_fewshot_tpu_torch.render.point_features import sample_point_features, select_view
from nerf_fewshot_tpu_torch.render.train_kernel import fused_train_loss_grad, grad_buffer
from nerf_fewshot_tpu_torch.training.config import Config
from nerf_fewshot_tpu_torch.training.losses import nerf_loss
from nerf_fewshot_tpu_torch.training.metrics import LPIPSMetric, psnr, ssim
from nerf_fewshot_tpu_torch.training.optim import (
    AdamKernel,
    clip_by_global_norm_,
    make_optimizer,
    multistep_lr,
    set_learning_rate,
)
from nerf_fewshot_tpu_torch.training.step_graph import WARMUP_STEPS, StaticStep, StepGraph
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
                     projection: str = "reference",
                     batch_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                     ) -> PointFeaturesFn:
    """Per-point conditioning: project (N, 3) points into the view of
    ``pose`` and sample ``feat_map`` (Hp, Wp, Fd) there bilinearly.
    ``projection='reference'`` is the proper-inverse projection with its
    validity mask, ``'script'`` the standalone scripts' forward-rotation one
    (no mask). ``invalid_fill='mean'`` replaces the features of invalid
    projections by the mean over all sampled features, the zero-filled
    invalid ones included: the multiscale trainer's quirk, reproduced.
    ``batch_mean(f) -> (1, Fd)`` takes that mean over the points of every
    rank when the call sees one rank's shard."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        if projection == "script":
            pts2d, _ = project_points_script(pts, pose, focal, H, W)
            return grid_sample(feat_map, pts2d, align_corners=align_corners)
        pts2d, _, valid = project_points_to_image(pts, pose, focal, H, W)
        f = grid_sample(feat_map, pts2d, align_corners=align_corners)
        if invalid_fill == "mean":
            mean = torch.mean(f, dim=0, keepdim=True) if batch_mean is None else batch_mean(f)
            f = torch.where(valid[:, None], f, mean)
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
    passes ``device="cpu"``), or on this rank's device of a data-parallel
    ``mesh``."""

    def __init__(
        self,
        cfg: Config,
        train_data: BlenderDataset,
        test_data: Optional[BlenderDataset] = None,
        device: DeviceLike = None,
        log_path: Optional[str] = None,
        dino_features: Optional[np.ndarray] = None,  # (V, Hp, Wp, Fd)
        mesh: Optional[Mesh] = None,
        _eager_step: bool = False,
    ):
        self.cfg = cfg
        self.mesh = mesh
        # the card's eager step, for the gates that hold the graph to it
        self._eager_step = _eager_step
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.train_data = train_data
        self.test_data = test_data
        self.H, self.W, self.focal = train_data.H, train_data.W, train_data.focal
        self.targets_full = np.asarray(train_data.white_composited(), np.float32)  # (V,H,W,3)
        self.poses = np.asarray(train_data.poses, np.float32)
        self.n_views = train_data.n_views
        self._poses_t = torch.as_tensor(self.poses, device=self.device)
        # each view's world-to-camera matrix, taken once here by the single-view
        # inverse the reference projection takes at every call
        # (project_points_to_image): the sampler kernel's pose stack
        self._w2c_t = torch.stack([torch.linalg.inv_ex(p)[0] for p in self._poses_t])
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
        self.optimizer = self._make_optimizer()
        # the two-phase freeze has swapped in the LoRA-only optimizer
        self._lora_only_active = False
        # "graph" or "eager" and why eager, set by every choice of the step
        self.step_mode: Optional[str] = None
        self.step_mode_reason: Optional[str] = None
        # the contiguous gradient buffers (model identity, flat, views by name),
        # and the last kernel step's gradients as the kernel gave them
        self._grads = None
        self._kernel_grads = None
        # the current phase's static-buffer step, and every capture's costs
        self._static: Optional[StaticStep] = None
        self.graph_captures = []
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

    def _make_optimizer(self, lora_only: bool = False) -> torch.optim.Optimizer:
        """The configured optimizer over the model's parameters, without the
        clip hook: every step clips first (``_optimizer_step``)."""
        return make_optimizer(self.cfg.optimizer, self.model.named_parameters(),
                              lora_only=lora_only, clip_hook=False)

    def feature_sampler(self, view: int, global_mean: bool = False) -> Optional[PointFeaturesFn]:
        """Train view ``view``'s conditioning closure, or None without
        conditioning. ``global_mean``: under a mesh, ``invalid_fill: mean``
        takes the mean over every rank's points (the JAX trainer's plain step
        does: its mean is over the sharded batch), by one all-reduce per
        call."""
        if not self.use_dino:
            return None
        return self._sampler(view, global_mean)

    def _sampler_kernel(self) -> bool:
        """Whether conditioning samples through ``csrc/point_features.cu``:
        on the kernel path on a card. The plain path and the CPU keep
        ``_feature_sampler``."""
        return self._use_fused() and self.device.type == "cuda"

    def _sampler(self, view: Union[int, torch.Tensor], global_mean: bool = False
                 ) -> PointFeaturesFn:
        """``feature_sampler`` of view ``view``, an int or a one-element
        int64 tensor on the device: with the DINO config's conventions and
        the full-resolution intrinsics, ``sample_point_features`` over the
        whole map stack and the per-view pose stack (``_sampler_kernel``),
        else ``_feature_sampler`` of the view's map and pose."""
        d = self.cfg.dino
        mesh = self.mesh if global_mean and d.invalid_fill == "mean" else None
        if self._sampler_kernel():
            batch_sum = None
            if mesh is not None:
                def batch_sum(s, n):
                    (total,) = all_reduce_sum(mesh, [s])
                    return total, n * mesh.world_size

            maps = self.dino_features
            poses = self._poses_t if d.projection == "script" else self._w2c_t

            def fn(pts: torch.Tensor) -> torch.Tensor:
                return sample_point_features(
                    pts.contiguous(), maps, view, poses, self.focal, self.H, self.W,
                    align_corners=d.align_corners, projection=d.projection,
                    invalid_fill=d.invalid_fill, batch_sum=batch_sum)

            return fn

        batch_mean = None
        if mesh is not None:
            def batch_mean(f):
                (total,) = all_reduce_sum(mesh, [torch.sum(f, dim=0, keepdim=True)])
                return total / (f.shape[0] * mesh.world_size)

        return _feature_sampler(
            select_view(self.dino_features, view), select_view(self._poses_t, view), self.focal,
            self.H, self.W, align_corners=d.align_corners, invalid_fill=d.invalid_fill,
            projection=d.projection, batch_mean=batch_mean)

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

    def _use_fused(self) -> bool:
        """Whether training steps and renders go through the kernels
        (``fused_train_loss_grad``, ``fused_render_rays``): the CUDA kernels
        on a card, their plain versions on the CPU. Records the choice in
        ``kernel_path`` ("kernel" or "plain") and ``kernel_path_reason``.

        ``backend: xla`` takes the plain path. A config the JAX kernels do
        not take takes it too under ``auto``, on every device, as the JAX
        trainer does, and raises under ``fused``. Every config the JAX
        kernels take, the port's kernels take too."""
        backend = self.cfg.rendering.backend
        where = self.device.type
        jax_reason = self._jax_ineligible_reason()
        if backend == "xla":
            reason = "rendering.backend: xla"
        elif jax_reason is not None:
            if backend == "fused":
                raise ValueError(f"rendering.backend=fused rejected on {where}: {jax_reason}")
            reason = jax_reason
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
        inline-PE forward kernel on the kernel path, with the weights packed
        once, here: the returned function renders the model as it was when
        it was made); otherwise
        differentiable in the model's parameters (the fused ``fused_render``
        on the kernel path, autograd on the plain one, which also takes the
        sigma-noise ``normals`` and ``fine_normals``)."""
        cfg = self.cfg
        if self._use_fused():
            n = cfg.nerf
            packed = None
            if forward_only:  # the weights as they are now, packed once for every call
                params = self.model.state_dict()
                consts = pe_constants(n.pos_freq, n.dir_freq, n.use_viewdirs,
                                      0 if pf is None else self.dino_features.shape[-1],
                                      self.device)
                packed = pack_params(params, n.num_layers, n.hidden_dim,
                                     d_pad=pe_width(consts.x_dim), row_perm=consts.row_perm,
                                     lora_alpha=n.lora_alpha)
            else:
                params = dict(self.model.named_parameters())

            def fn(ro, rd, uniforms=None, importance_uniforms=None) -> RenderOutputs:
                return fused_render_rays(
                    params, ro, rd, settings,
                    pos_freq=n.pos_freq, dir_freq=n.dir_freq,
                    num_layers=n.num_layers, hidden_dim=n.hidden_dim,
                    use_viewdirs=n.use_viewdirs,
                    compute_dtype=cfg.rendering.compute_dtype,
                    forward_only=forward_only, device=self.device,
                    uniforms=uniforms, importance_uniforms=importance_uniforms,
                    point_features_fn=pf, lora_alpha=n.lora_alpha, packed=packed,
                )

            return fn

        def fn(ro, rd, uniforms=None, importance_uniforms=None, normals=None,
               fine_normals=None) -> RenderOutputs:
            with torch.set_grad_enabled(torch.is_grad_enabled() and not forward_only):
                return render_rays(self.model, ro, rd, settings, uniforms, importance_uniforms,
                                   point_features_fn=pf, normals=normals,
                                   fine_normals=fine_normals)

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
        the rays rounded as the JAX trainer's host op rounds them
        (``phase_rays``), targets resized bilinearly (torch semantics,
        ``align_corners=False``)."""
        if phase_idx in self._phase_data:
            return self._phase_data[phase_idx]
        p = self.cfg.phases[phase_idx]
        Hp, Wp = p.H, p.W
        focal = self.focal * (Hp / self.H) if self.cfg.focal_scaling else self.focal
        ros, rds, tgts = [], [], []
        for v in range(self.n_views):
            ro, rd = phase_rays(Hp, Wp, focal, torch.as_tensor(self.poses[v], device=self.device))
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

    def _grad_buffer(self) -> torch.Tensor:
        """The flat buffer of the step's gradients, made once per model
        (``grad_buffer``), its views the parameters' ``.grad``; under a mesh
        one element more, the loss's slot of the step's all-reduce."""
        named = list(self.model.named_parameters())
        key = tuple(id(p) for _, p in named)
        if self._grads is None or self._grads[0] != key:
            flat, views = grad_buffer(dict(named), self.cfg.nerf.num_layers,
                                      extra=0 if self.mesh is None else 1)
            self._grads = (key, flat, views)
        _, flat, views = self._grads
        for name, p in named:
            if p.grad is not views[name]:
                p.grad = views[name]
        return flat

    def _kernel_loss_grad(self, ro, rd, tgt, mask, settings, draws, view, dp=None,
                          pf=None, denom=None) -> torch.Tensor:
        """One step's loss on train view ``view`` (an int, or under a mesh
        also a device index; or conditioned by ``pf``); its gradients land
        in the contiguous ``.grad`` buffers of ``_grad_buffer``, under a mesh
        through ``dp`` (``_dp_loss_grad``), summed over the ranks with the
        loss, ``denom`` the batch's valid-ray count. Off a mesh
        ``_kernel_grads`` keeps the gradients as the kernel gave them, which
        the clip's norm sums over (``_optimizer_step``)."""
        cfg = self.cfg
        self._kernel_grads = None
        if dp is not None:
            loss, _ = dp(self.model, draws["uniforms"], ro, rd, tgt, mask,
                         *((view,) if self.use_dino else ()),
                         importance_uniforms=draws["importance_uniforms"], denom_rays=denom,
                         grad_buffer=self._grad_buffer())
            return loss
        loss, self._kernel_grads = fused_train_loss_grad(
            self.model, ro, rd, tgt, mask, settings,
            pos_freq=cfg.nerf.pos_freq, dir_freq=cfg.nerf.dir_freq,
            num_layers=cfg.nerf.num_layers, hidden_dim=cfg.nerf.hidden_dim,
            use_viewdirs=cfg.nerf.use_viewdirs, compute_dtype=cfg.rendering.compute_dtype,
            uniforms=draws["uniforms"], importance_uniforms=draws["importance_uniforms"],
            point_features_fn=self.feature_sampler(view) if pf is None else pf,
            rgb_weight=float(cfg.loss.rgb_weight),
            reg_weight=self._kernel_reg_weight(), lora_alpha=cfg.nerf.lora_alpha,
            grad_buffer=self._grad_buffer(),
        )
        return loss

    def _optimizer_step(self, grads: Optional[Mapping[str, torch.Tensor]] = None,
                        adam: Optional[AdamKernel] = None) -> None:
        """The configured global-norm clip of the optimizer's ``.grad``, its
        norm summed over ``grads`` (by name, as the kernel gave them) when
        given, then one step: ``adam``'s when given, else the optimizer's."""
        clip = self.cfg.optimizer.grad_clip
        if clip > 0:
            params = self.optimizer.param_groups[0]["params"]
            norm_grads = None
            if grads is not None:
                names = {id(p): n for n, p in self.model.named_parameters()}
                norm_grads = [grads[names[id(p)]] for p in params]
            clip_by_global_norm_(params, float(clip), norm_grads)
        if adam is not None:
            adam.step()
        else:
            self.optimizer.step()

    def _kernel_reg_weight(self) -> float:
        cfg = self.cfg
        return 0.0 if cfg.strict_reference_behavior else float(cfg.loss.reg_weight)

    def _plain_loss_grad(self, ro, rd, tgt, mask, settings, draws, view, denom=None
                         ) -> torch.Tensor:
        """One plain step's loss on train view ``view`` (``render_rays`` and
        autograd); its gradients land in ``.grad``. ``denom``: the batch's
        valid-ray count when ``mask`` is this rank's shard; the loss and the
        gradients are then summed over the ranks, in one all-reduce."""
        cfg = self.cfg
        pf = self.feature_sampler(view, global_mean=True)
        out = self._ray_render_fn(settings, pf=pf)(ro, rd, **draws)
        losses = nerf_loss(
            out.rgb, tgt, cfg.loss,
            weights=None if cfg.strict_reference_behavior else out.weights, mask=mask,
            denom_rays=denom,
        )
        self.model.zero_grad(set_to_none=True)
        losses["total"].backward()
        loss = losses["total"].detach()
        if self.mesh is not None:
            params = [p for p in self.model.parameters() if p.grad is not None]
            loss, *grads = all_reduce_sum(self.mesh, [loss, *(p.grad for p in params)])
            for p, g in zip(params, grads):
                p.grad = g
        return loss

    def _draws(self, B: int, n_samples: int,
               settings: RenderSettings) -> Dict[str, Optional[torch.Tensor]]:
        """One step's random draws for the whole batch, from the trainer's
        generator in this order: the stratified-jitter uniforms (B,
        n_samples) and the importance uniforms (B, n_importance) when
        ``settings.perturb``; with sigma noise (plain path only) the normals
        of the coarse and of the fine pass. Every rank of a mesh draws the
        same, and takes its rows."""
        g, dev = self._generator, self.device
        ni = settings.n_importance
        draws: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
            ("uniforms", "importance_uniforms"))
        if settings.perturb:
            draws["uniforms"] = torch.rand((B, n_samples), generator=g, device=dev)
            if ni > 0:
                draws["importance_uniforms"] = torch.rand((B, ni), generator=g, device=dev)
        if settings.noise_std > 0.0:
            draws["normals"] = torch.randn((B, n_samples), generator=g, device=dev)
            draws["fine_normals"] = (torch.randn((B, n_samples + ni), generator=g, device=dev)
                                     if ni > 0 else None)
        return draws

    def _batch_granularity(self) -> int:
        return 1 if self.mesh is None else self.mesh.world_size

    def _dp_loss_grad(self, settings: RenderSettings) -> Callable:
        """The kernel path's step under the mesh (``make_dp_fused_loss_grad``)
        at ``settings``, DINO-conditioned through ``feature_sampler``."""
        cfg = self.cfg
        return make_dp_fused_loss_grad(
            self.mesh, settings, cfg.nerf.pos_freq, cfg.nerf.dir_freq, cfg.nerf.num_layers,
            cfg.nerf.hidden_dim, use_viewdirs=cfg.nerf.use_viewdirs,
            lora_alpha=cfg.nerf.lora_alpha, compute_dtype=cfg.rendering.compute_dtype,
            point_features_builder=self.feature_sampler if self.use_dino else None,
            reg_weight=self._kernel_reg_weight(), rgb_weight=float(cfg.loss.rgb_weight))

    def _use_graph(self) -> bool:
        """Whether this epoch's steps run as CUDA graph replays (the kernel
        path on a card, off a mesh or under an NCCL one). Records the choice
        in ``step_mode`` ("graph" or "eager") and ``step_mode_reason``."""
        reason = None
        if not self._use_fused():
            reason = f"the plain path ({self.kernel_path_reason})"
        elif self.mesh is not None and not can_capture(self.mesh):
            reason = (f"a {self.mesh.backend} mesh: its collectives run on the host and cannot "
                      f"be captured in a CUDA graph")
        elif self.device.type != "cuda":
            reason = f"no CUDA graph on {self.device.type}"
        elif self._eager_step:
            reason = "the card's eager step, asked for by Trainer(_eager_step=True)"
        self.step_mode = "graph" if reason is None else "eager"
        self.step_mode_reason = reason
        return reason is None

    def _epoch_batches(self, n_rays: int, B: int) -> Tuple[np.ndarray, np.ndarray]:
        """The epoch's minibatches: ``idxs`` (V, n_batches, B), each view's
        fresh permutation (``np.random.default_rng(cfg.seed)``, one draw per
        view in view order, as the JAX trainer draws them) with the ragged
        tail padded with index 0, and ``masks`` (n_batches, B), 0 on the
        padding (the same for every view)."""
        n_batches = (n_rays + B - 1) // B
        pad_total = n_batches * B - n_rays
        idxs = np.empty((self.n_views, n_batches, B), np.int64)
        masks = np.ones((n_batches * B,), np.float32)
        masks[n_rays:] = 0.0
        for v in range(self.n_views):
            perm = self._np_rng.permutation(n_rays)
            idxs[v] = np.concatenate([perm, np.zeros(pad_total, perm.dtype)]).reshape(n_batches, B)
        return idxs, masks.reshape(n_batches, B)

    def train_epoch(self, epoch: int) -> float:
        """One epoch over all views: a fresh permutation per view, the
        ragged tail padded with index 0 and mask 0, one optimizer step per
        minibatch. Under a mesh the batch is padded to a multiple of the
        world size and each rank takes its rows of it. Returns the mean step
        loss. The steps (``epoch_steps``) only enqueue work; the copy of
        their losses to the host is the epoch's one synchronization."""
        self.last_step_losses = self.epoch_steps(epoch).cpu().numpy()
        return float(np.mean(self.last_step_losses))

    def epoch_steps(self, epoch: int) -> torch.Tensor:
        """``train_epoch``'s steps: the per-step losses as one tensor on the
        device. On a card the host waits for the device nowhere in here (the
        batch indices reach it by a stream-ordered copy from pinned memory),
        once the phase's data (``phase_data``) is on the device. On the
        kernel path on a card, off a mesh or under an NCCL one, the steps
        are replays of the phase's CUDA graph (``_static_epoch``); elsewhere
        each step is dispatched op by op."""
        cfg = self.cfg
        phase_idx = self._begin_epoch(epoch)
        if self._use_graph():
            return self._static_epoch(phase_idx, graphed=True)
        p = cfg.phases[phase_idx]
        pd = self.phase_data(phase_idx)
        n_rays = pd.rays_o.shape[1]
        B = min(p.batch_size, n_rays)
        g = self._batch_granularity()
        B = -(-B // g) * g  # equal shards (JAX trainer.py:581-583)
        idxs, masks = self._epoch_batches(n_rays, B)
        n_batches = masks.shape[0]
        idxs_t = to_device(idxs, self.device)
        masks_t = to_device(masks, self.device)

        settings = self._render_settings(p.n_samples, training=True)
        fused = self._use_fused()
        rows = slice(0, B) if self.mesh is None else process_local_slice(B, self.mesh)
        dp = self._dp_loss_grad(settings) if fused and self.mesh is not None else None
        losses = []
        for v in range(self.n_views):
            # steps sample view v's map and pose (JAX trainer.py:608-613)
            view_packed = torch.cat([pd.rays_o[v], pd.rays_d[v], pd.targets[v]], dim=1)
            for b in range(n_batches):
                row = view_packed[idxs_t[v, b, rows]]
                draws = {k: None if d is None else d[rows]
                         for k, d in self._draws(B, p.n_samples, settings).items()}
                mask = masks_t[b]
                args = (row[:, 0:3], row[:, 3:6], row[:, 6:9], mask[rows], settings, draws, v)
                grads = None
                denom = None if self.mesh is None else torch.sum(mask)
                if fused:
                    loss = self._kernel_loss_grad(*args, dp=dp, denom=denom)
                    grads = self._kernel_grads
                else:
                    loss = self._plain_loss_grad(*args, denom=denom)
                losses.append(loss)
                self._optimizer_step(grads)
        return torch.stack(losses)

    def _begin_epoch(self, epoch: int) -> int:
        """An epoch's set-up, whatever runs its steps: the phase's data on the
        device, the two-phase freeze, the epoch's lr. Returns the phase."""
        cfg = self.cfg
        phase_idx = self._phase_index(epoch)
        self.phase_data(phase_idx)
        boundary = cfg.optimizer.lora_only_after_epoch
        if boundary and epoch >= boundary and not self._lora_only_active:
            # the two-phase freeze (JAX trainer.py:567-575): a fresh
            # optimizer over the LoRA parameters alone, once
            self.optimizer = self._make_optimizer(lora_only=True)
            self._lora_only_active = True
        set_learning_rate(self.optimizer, self.lr_at(epoch))
        return phase_idx

    # ------------------------------------------------- the static-buffer step

    def _static_epoch_steps(self, epoch: int) -> torch.Tensor:
        """``epoch_steps`` through the static-buffer body run as it is, with
        no graph (the kernel path, off a mesh or under one): the CPU tests
        hold it to the eager steps bit for bit."""
        phase_idx = self._begin_epoch(epoch)
        if not self._use_fused():
            raise ValueError("the static-buffer step is the kernel path's")
        return self._static_epoch(phase_idx, graphed=False)

    def _static_step(self, phase_idx: int) -> StaticStep:
        """The phase's ``StaticStep``, made at the phase's first epoch (the
        previous phase's, and its graph, dropped), with an ``AdamKernel``
        over the current optimizer: a new one, and no graph, after the
        optimizer or its state tensors were replaced (the freeze, a
        ``load``). Under a mesh the batch is padded to a multiple of the
        world size, as ``epoch_steps`` pads it, and ``shard`` is this
        rank's rows of it."""
        st = self._static
        if st is None or st.phase_idx != phase_idx:
            self._static = st = None
            p = self.cfg.phases[phase_idx]
            pd = self.phase_data(phase_idx)
            n_rays = pd.rays_o.shape[1]
            B = min(p.batch_size, n_rays)
            g = self._batch_granularity()
            B = -(-B // g) * g  # equal shards (JAX trainer.py:581-583)
            n_steps = self.n_views * ((n_rays + B - 1) // B)
            dev = self.device
            rays = torch.cat([pd.rays_o, pd.rays_d, pd.targets], dim=2).reshape(-1, 9)
            settings = self._render_settings(p.n_samples, training=True)
            st = StaticStep(
                phase_idx=phase_idx, batch=B, n_batches=n_steps // self.n_views,
                n_samples=p.n_samples, settings=settings,
                shard=slice(0, B) if self.mesh is None else process_local_slice(B, self.mesh),
                rays=rays, rows=torch.zeros((n_steps, B), dtype=torch.int64, device=dev),
                mask=torch.zeros((n_steps, B), dtype=torch.float32, device=dev),
                views=torch.zeros(n_steps, dtype=torch.int64, device=dev),
                losses=torch.zeros(n_steps, dtype=torch.float32, device=dev))
            self._static = st
        self._grad_buffer()
        if st.adam is None or not st.adam.is_current(self.optimizer):
            st.graph = None
            st.adam = AdamKernel(self.optimizer,
                                 [p.grad for p in self.optimizer.param_groups[0]["params"]],
                                 st.n_steps, self.device)
        return st

    def _begin_static_epoch(self, st: StaticStep) -> None:
        """The epoch's host work: its minibatches (``_epoch_batches``) as
        rows of ``st.rays``, their masks and views, each one stream-ordered
        copy into the phase's buffers, and the Adam kernel's table for the
        epoch's steps at its lr."""
        n_rays = st.rays.shape[0] // self.n_views
        idxs, masks = self._epoch_batches(n_rays, st.batch)
        rows = idxs + (np.arange(self.n_views, dtype=np.int64) * n_rays)[:, None, None]
        st.rows.copy_(to_device(rows.reshape(st.n_steps, st.batch), self.device))
        st.mask.copy_(to_device(np.tile(masks, (self.n_views, 1)), self.device))
        st.views.copy_(to_device(np.repeat(np.arange(self.n_views, dtype=np.int64),
                                           st.n_batches), self.device))
        st.adam.begin_epoch(st.n_steps)

    def _static_body(self, st: StaticStep) -> None:
        """One step that reads only device buffers and the device step index
        (``st.adam.counter[0]``): the batch's rows (this rank's, ``st.shard``),
        mask and view gathered by it, the whole batch's jitter drawn and the
        rank's rows taken, the objective and its gradients into the ``.grad``
        buffers (under a mesh summed over the ranks with the loss, by the
        all-reduce of ``_dp_loss_grad``), the loss into ``st.losses``, the clip and
        the Adam step, which moves the index on."""
        step = st.adam.counter[:1]
        row = st.rays.index_select(0, st.rows.index_select(0, step).reshape(-1)[st.shard])
        mask = st.mask.index_select(0, step).reshape(-1)
        view = st.views.index_select(0, step) if self.use_dino else None
        draws = {k: None if d is None else d[st.shard]
                 for k, d in self._draws(st.batch, st.n_samples, st.settings).items()}
        args = (row[:, 0:3], row[:, 3:6], row[:, 6:9], mask[st.shard], st.settings, draws)
        if self.mesh is None:
            pf = self._sampler(view) if self.use_dino else None
            loss = self._kernel_loss_grad(*args, None, pf=pf)
        else:
            # built per call, not kept in ``st``: its sampler is bound to the
            # trainer, and a trainer in a reference cycle would keep its
            # graphs, and so the NCCL communicator, alive (``mesh.shutdown``)
            loss = self._kernel_loss_grad(*args, view, dp=self._dp_loss_grad(st.settings),
                                          denom=torch.sum(mask))
        st.losses.index_copy_(0, step, loss.reshape(1))
        self._optimizer_step(self._kernel_grads, adam=st.adam)

    def _static_epoch(self, phase_idx: int, graphed: bool) -> torch.Tensor:
        """An epoch of the static-buffer step: the host work once, then each
        step the body, run as it is (``graphed`` False: the CPU tests hold it
        to the eager steps) or as a replay of the phase's CUDA graph,
        captured at the phase's first epoch (or after the optimizer was
        replaced) after ``WARMUP_STEPS`` eager steps on a side stream. Under
        an NCCL mesh every rank captures at the same epoch and replays as
        often: the warm-up makes the communicator, outside the capture."""
        st = self._static_step(phase_idx)
        n = st.n_steps
        self._begin_static_epoch(st)
        done = 0
        if not graphed:
            for _ in range(n):
                self._static_body(st)
            done = n
        elif st.graph is None:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(min(WARMUP_STEPS, n)):
                    self._static_body(st)
                    done += 1
                st.graph = StepGraph(lambda: self._static_body(st), side, self._generator)
            cur.wait_stream(side)
            self.graph_captures.append({
                "phase": phase_idx, "capture_ms": st.graph.capture_ms,
                "instantiate_ms": st.graph.instantiate_ms, "pool_mb": st.graph.pool_mb,
                "launches_per_replay": dict(st.graph.launches)})
        for _ in range(n - done):
            st.graph.replay()
        st.adam.end_epoch(n)
        return st.losses.clone()

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
        quirk); on the kernel path every chunk shares one packing of the
        weights (``_ray_render_fn``)."""
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
        rgb, depth and acc numpy arrays, copied to the host at the end in
        one copy: the call's one synchronization (``render_views_device``)."""
        outs = self.render_views_device(poses, n_samples)
        flat = torch.cat([t.reshape(-1) for t in outs]).cpu().numpy()
        sizes = np.cumsum([t.numel() for t in outs])[:-1]
        return tuple(a.reshape(t.shape) for a, t in zip(np.split(flat, sizes), outs))

    def render_views_device(
        self, poses: Sequence, n_samples: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``render_views``' renders as tensors on the device. On a card the
        host waits for the device nowhere in here: the poses reach it by one
        stream-ordered copy, the weights are packed once for every chunk."""
        cfg = self.cfg
        if n_samples is None:
            n_samples = cfg.phases[-1].n_samples
        chunk_size = cfg.rendering.chunk_size
        fn = self._eval_chunk_fn(n_samples)
        poses_t = to_device(np.stack([np.asarray(p, np.float32) for p in poses]), self.device)
        ros, rds = [], []
        for pose in poses_t:
            ro, rd = get_rays(self.H, self.W, self.focal, pose)
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
        return rgb, depth, acc

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
