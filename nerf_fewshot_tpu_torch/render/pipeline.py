"""Plain ray-rendering pipeline: sampling -> MLP -> compositing
(counterpart of ``nerf_fewshot_tpu/render/pipeline.py``, the XLA path).

The fused path (``render.fused``) and the training kernel are held against
this one. It is the only path with sigma noise (the kernels refuse it, as
the JAX kernels do).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from nerf_fewshot_tpu_torch.ops.composite import RenderOutputs, volume_render
from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays

# model_fn(pts (N,3), dirs (N,3)[, feats (N,Fd)]) -> (rgb (N,3), sigma (N,1))
ModelFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
# point_features_fn(pts (N,3)) -> (N, Fd) conditioning features
PointFeaturesFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static rendering configuration (same fields as the JAX one)."""

    near: float = 2.0
    far: float = 6.0
    n_samples: int = 64
    n_importance: int = 0
    perturb: bool = False
    noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False


def render_rays(
    model_fn: ModelFn,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    uniforms: Optional[torch.Tensor] = None,
    importance_uniforms: Optional[torch.Tensor] = None,
    point_features_fn: Optional[PointFeaturesFn] = None,
    normals: Optional[torch.Tensor] = None,
    fine_normals: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> RenderOutputs:
    """Render (R, 3) rays. ``point_features_fn`` gives each sample point's
    features, the model's third input. With ``settings.perturb`` the (R, n_samples)
    ``uniforms`` jitter the stratified samples and the (R, n_importance)
    ``importance_uniforms`` draw the hierarchical samples; without them (or
    without ``perturb``) both are deterministic, as the JAX path with
    ``key=None``. With ``settings.n_importance`` the fine pass re-renders the
    merged samples with the same model, from the coarse weights under
    stop-gradient, and its outputs are returned.

    With ``settings.noise_std > 0`` the density of the coarse pass gets
    ``noise_std * normals`` (R, n_samples) and that of the fine pass
    ``noise_std * fine_normals`` (R, n_samples + n_importance): standard
    normals given by the caller or, where one is not given, drawn from
    ``generator``; with neither there is no noise, as the JAX path without
    a key. The four draws are the JAX path's four split keys (strata,
    noise, importance, fine noise), so a caller can inject its draws."""
    pts, z_vals = sample_along_rays(
        rays_o, rays_d, settings.near, settings.far, settings.n_samples,
        uniforms=uniforms if settings.perturb else None, lindisp=settings.lindisp,
    )
    out = _render_points(model_fn, pts, z_vals, rays_d, settings, point_features_fn,
                         _normals(normals, settings, z_vals, generator))
    if settings.n_importance <= 0:
        return out
    pts, z_vals = hierarchical_sample(
        rays_o, rays_d, z_vals, out.weights.detach(), settings.n_importance,
        uniforms=importance_uniforms if settings.perturb else None,
    )
    return _render_points(model_fn, pts, z_vals, rays_d, settings, point_features_fn,
                          _normals(fine_normals, settings, z_vals, generator))


def _normals(normals: Optional[torch.Tensor], settings: RenderSettings, z_vals: torch.Tensor,
             generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """A pass's sigma-noise normals: the given ones, else a draw from
    ``generator`` of ``z_vals``' shape, else None; None without noise."""
    if settings.noise_std <= 0.0:
        return None
    if normals is None and generator is not None:
        normals = torch.randn(z_vals.shape, generator=generator, device=z_vals.device,
                              dtype=z_vals.dtype)
    return normals


def _render_points(model_fn: ModelFn, pts, z_vals, rays_d, settings: RenderSettings,
                   point_features_fn: Optional[PointFeaturesFn] = None,
                   normals: Optional[torch.Tensor] = None):
    """Evaluate the model at the (R, S, 3) points and composite them, the
    density noised by ``settings.noise_std * normals`` where given."""
    R, S, _ = pts.shape
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    pts_flat = pts.reshape(-1, 3)
    if point_features_fn is None:
        rgb, sigma = model_fn(pts_flat, dirs)
    else:
        rgb, sigma = model_fn(pts_flat, dirs, point_features_fn(pts_flat))
    return volume_render(
        rgb.reshape(R, S, 3), sigma.reshape(R, S), z_vals, rays_d,
        noise_std=settings.noise_std, normals=normals, white_bkgd=settings.white_bkgd,
    )


def render_image_with(
    ray_render_fn: Callable[[torch.Tensor, torch.Tensor], RenderOutputs],
    rays_o: torch.Tensor,  # (H, W, 3)
    rays_d: torch.Tensor,
    chunk_size: int = 2048,
) -> RenderOutputs:
    """Render a full image in fixed-size ray chunks with any per-ray
    renderer; the last chunk is padded with copies of the last ray."""
    H, W, _ = rays_o.shape
    n = H * W
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    pad = (-n) % chunk_size
    if pad:
        ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
        rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
    outs = [
        ray_render_fn(ro[i:i + chunk_size], rd[i:i + chunk_size])
        for i in range(0, ro.shape[0], chunk_size)
    ]
    rgb = torch.cat([o.rgb for o in outs])[:n]
    depth = torch.cat([o.depth for o in outs])[:n]
    acc = torch.cat([o.acc for o in outs])[:n]
    weights = torch.cat([o.weights for o in outs])[:n]
    return RenderOutputs(
        rgb=rgb.reshape(H, W, 3),
        depth=depth.reshape(H, W),
        acc=acc.reshape(H, W),
        weights=weights.reshape(H, W, weights.shape[-1]),
    )


def render_image(
    model_fn: ModelFn,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    chunk_size: int = 2048,
) -> RenderOutputs:
    """Deterministic full-image render on the plain path."""
    return render_image_with(
        lambda o, d: render_rays(model_fn, o, d, settings),
        rays_o, rays_d, chunk_size=chunk_size,
    )
