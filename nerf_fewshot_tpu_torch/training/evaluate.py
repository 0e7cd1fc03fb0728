"""Checkpoint analysis harness (counterpart of
``nerf_fewshot_tpu/training/evaluate.py``): the reference's four analyses
and the metric suite.

1. Novel views on a generated orbit (radius 4.0, elevation 30 degrees).
2. Feature 3D-consistency: shared 3D points projected into every training
   view, features sampled there, the pairwise cosine-similarity matrix.
3. Depth statistics over test views, with colormapped depth maps and
   histograms.
4. Smoothness of the learned field on a 3D grid, and of the raw sampled
   feature grid.

Every view is rendered by ``Trainer.render_views``: through the inline-PE
render kernel (kernel 2) on a card on the kernel path, conditioned on
train view 0's features whatever the pose (the reference's eval quirk).
There the analyses' feature samples come from the sampler kernel
(``csrc/point_features.cu``) too.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from nerf_fewshot_tpu_torch.data.synthetic import orbit_pose
from nerf_fewshot_tpu_torch.ops.interp import grid_sample
from nerf_fewshot_tpu_torch.ops.rays import project_points_to_image
from nerf_fewshot_tpu_torch.render.point_features import sample_point_features_valid
from nerf_fewshot_tpu_torch.utils.logging import save_png
from nerf_fewshot_tpu_torch.utils.plots import save_colormapped, save_heatmap, save_histogram


def generate_orbit_poses(n_poses: int = 8, radius: float = 4.0,
                         elevation_deg: float = 30.0) -> np.ndarray:
    """(n_poses, 4, 4) camera-to-world poses on a circular orbit looking at
    the origin, azimuths evenly spaced from 0."""
    phi = np.deg2rad(elevation_deg)
    thetas = np.linspace(0.0, 2 * np.pi, n_poses, endpoint=False)
    return np.stack([orbit_pose(t, phi, radius) for t in thetas]).astype(np.float32)


def novel_view_synthesis(trainer, out_dir: str, n_orbit: int = 8) -> List[str]:
    """Render an orbit of ``n_orbit`` novel views as one chunk stream and
    write ``novel_XX.png``; returns the paths."""
    rgbs, _, _ = trainer.render_views(list(generate_orbit_poses(n_orbit)))
    paths = []
    for i, rgb in enumerate(rgbs):
        p = os.path.join(out_dir, f"novel_{i:02d}.png")
        save_png(p, np.clip(rgb, 0, 1))
        paths.append(p)
    return paths


def _view_features(trainer, view: int, pts: torch.Tensor):
    """Train view ``view``'s map sampled at the reference projection of
    ``pts``: ``(features (N, Fd), valid (N,))`` as numpy; on a kernel-path
    trainer on a card by ``csrc/point_features.cu``."""
    if trainer._sampler_kernel():
        f, valid = sample_point_features_valid(
            pts.contiguous(), trainer.dino_features, view, trainer._w2c_t, trainer.focal,
            trainer.H, trainer.W, align_corners=trainer.cfg.dino.align_corners,
            projection="reference", invalid_fill="zeros")
        return f.cpu().numpy(), valid.cpu().numpy()
    p2d, _, valid = project_points_to_image(pts, trainer._poses_t[view], trainer.focal,
                                            trainer.H, trainer.W)
    f = grid_sample(trainer.dino_features[view], p2d,
                    align_corners=trainer.cfg.dino.align_corners)
    return f.cpu().numpy(), valid.cpu().numpy()


def feature_3d_consistency(trainer, n_points: int = 256, out_dir: str = None) -> Dict[str, Any]:
    """Mean cosine similarity of every pair of training views' features at
    ``n_points`` shared points (uniform in [-1.5, 1.5]^3 from
    ``default_rng(0)``); the diagonal is filled with 1, as the reference
    does. With ``out_dir``, writes ``consistency_matrix.png``. Needs feature
    conditioning."""
    if not trainer.use_dino:
        return {"available": False}
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1.5, 1.5, (n_points, 3)).astype(np.float32),
                          device=trainer.device)
    V = trainer.n_views
    feats = [_view_features(trainer, v, pts)[0] for v in range(V)]
    sim = np.zeros((V, V))
    for i in range(V):
        for j in range(i + 1, V):
            a, b = feats[i], feats[j]
            num = (a * b).sum(-1)
            den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-8
            sim[i, j] = sim[j, i] = float(np.mean(num / den))
    np.fill_diagonal(sim, 1.0)
    off_diag = sim[~np.eye(V, dtype=bool)]
    if out_dir is not None:
        save_heatmap(os.path.join(out_dir, "consistency_matrix.png"), sim, cmap="viridis")
    return {"available": True, "matrix": sim.tolist(),
            "mean_cross_view_similarity": float(off_diag.mean())}


def depth_statistics(trainer, max_views: int = 3, out_dir: str = None) -> Dict[str, Any]:
    """Depth statistics of the first ``max_views`` test views (mean and std
    over the foreground ``acc > 0.5``, min, max, foreground fraction). With
    ``out_dir``, writes ``depth_view_i.png`` (plasma) and
    ``depth_hist_view_i.png`` (50 bins)."""
    if trainer.test_data is None:
        return {"available": False}
    n = min(max_views, trainer.test_data.n_views)
    _, depths, accs = trainer.render_views([trainer.test_data.poses[i] for i in range(n)])
    stats = []
    for i in range(n):
        d, fg = depths[i], accs[i] > 0.5
        if out_dir is not None:
            save_colormapped(os.path.join(out_dir, f"depth_view_{i}.png"), d, cmap="plasma")
            save_histogram(os.path.join(out_dir, f"depth_hist_view_{i}.png"), d.ravel(), bins=50)
        stats.append({
            "view": i,
            "depth_mean": float(d[fg].mean()) if fg.any() else 0.0,
            "depth_std": float(d[fg].std()) if fg.any() else 0.0,
            "depth_min": float(d.min()),
            "depth_max": float(d.max()),
            "foreground_fraction": float(fg.mean()),
        })
    return {"available": True, "per_view": stats}


@torch.no_grad()
def feature_interpolation_smoothness(trainer, grid_n: int = 8) -> Dict[str, float]:
    """Mean |delta sigma| and |delta rgb| between neighbours of a
    ``grid_n``^3 grid over [-1.2, 1.2]^3, the model's plain forward with
    direction (0, 0, -1) (and train view 0's features with conditioning)."""
    lin = torch.linspace(-1.2, 1.2, grid_n, device=trainer.device)
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    dirs = torch.tensor([0.0, 0.0, -1.0], device=trainer.device).expand(pts.shape)
    pf = trainer.feature_sampler(0)
    rgb, sigma = trainer.model(pts, dirs, None if pf is None else pf(pts))
    sigma = sigma.cpu().numpy().reshape(grid_n, grid_n, grid_n)
    rgb = rgb.cpu().numpy().reshape(grid_n, grid_n, grid_n, 3)
    ds = [np.abs(np.diff(sigma, axis=a)).mean() for a in range(3)]
    dc = [np.abs(np.diff(rgb, axis=a)).mean() for a in range(3)]
    return {"sigma_smoothness": float(np.mean(ds)), "rgb_smoothness": float(np.mean(dc))}


def raw_feature_smoothness(trainer, n_pairs: int = 1000) -> Dict[str, Any]:
    """The reference's own smoothness analysis: a 20x20x10 grid (x, y in
    [-2, 2], z in [2.5, 4.5], ``np.meshgrid``'s default ``xy`` indexing)
    projected into the first two training views, features sampled at the
    valid projections, the mean L2 distance over ``n_pairs`` random pairs
    (one ``default_rng(0)`` stream over both views)."""
    if not trainer.use_dino:
        return {"available": False}
    x = np.linspace(-2, 2, 20)
    y = np.linspace(-2, 2, 20)
    z = np.linspace(2.5, 4.5, 10)
    grid = np.stack(np.meshgrid(x, y, z), axis=-1).reshape(-1, 3)
    pts = torch.as_tensor(grid.astype(np.float32), device=trainer.device)
    rng = np.random.default_rng(0)
    results: Dict[str, Any] = {"available": True}
    for v in range(min(2, trainer.n_views)):
        feats, valid = _view_features(trainer, v, pts)
        fv = feats[valid]
        score = None
        if len(fv) > 100:
            idx = rng.choice(len(fv), (n_pairs, 2), replace=True)
            score = float(np.linalg.norm(fv[idx[:, 0]] - fv[idx[:, 1]], axis=-1).mean())
        results[f"view_{v}"] = {"smoothness_score": score, "n_valid_points": int(valid.sum())}
    return results


def comprehensive_evaluation(trainer, out_dir: str, n_orbit: int = 8) -> Dict[str, Any]:
    """Every analysis and the metric suite (``trainer.evaluate`` over up to
    8 test views, dumping renders); writes ``evaluation.json`` and the PNGs
    into ``out_dir`` and returns the results."""
    os.makedirs(out_dir, exist_ok=True)
    results: Dict[str, Any] = {"metrics": trainer.evaluate(max_views=8, dump_dir=out_dir)}
    novel_view_synthesis(trainer, out_dir, n_orbit=n_orbit)
    results["novel_views"] = n_orbit
    results["feature_3d_consistency"] = feature_3d_consistency(trainer, out_dir=out_dir)
    results["depth"] = depth_statistics(trainer, out_dir=out_dir)
    results["smoothness"] = feature_interpolation_smoothness(trainer)
    results["raw_feature_smoothness"] = raw_feature_smoothness(trainer)
    with open(os.path.join(out_dir, "evaluation.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results
