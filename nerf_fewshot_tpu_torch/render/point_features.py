"""The per-point feature sampler of the kernel path: ``csrc/point_features.cu``
and its plain version.

N world points are projected into one training view and that view's feature
map is sampled there bilinearly, with the DINO config's conventions: the
reference projection (through the view's world-to-camera matrix, with its
validity mask and, under ``invalid_fill: mean``, invalid rows replaced by the
mean over all sampled rows) or the standalone scripts' one (through the
camera-to-world matrix, no mask). The maps are a (V, Hp, Wp, Fd) stack and
the poses a (V, 4, 4) stack (w2c for ``reference``, c2w for ``script``); the
view is a Python int or a one-element int64 tensor on the points' device, so
a graphed step selects its view on the device, gathering neither map nor
pose.

The kernel replaces no Pallas kernel: it replaces XLA's fusion of the JAX
trainer's sampler closure (``nerf_fewshot_tpu/training/trainer.py:76-105``:
``project_points_to_image`` / ``project_points_script`` and ``grid_sample``),
which eager PyTorch runs as about a hundred small kernels with a 4x4 inverse
per call. Its bound is the bytes it moves (each point read once, its
features and valid flag written once); its design is one pass and no
intermediates (the source's note). It has no backward: the maps are frozen
in every config and no gradient reaches the points, so the wrapper refuses
a map or points that require grad rather than drop a gradient.

``sample_point_features`` / ``sample_point_features_valid`` run the plain
version (``point_features_reference``, the arithmetic of ``ops/rays.py``
and ``ops/interp.py`` on the selected view) on CPU tensors; on CUDA tensors
they launch the kernel, or raise, and count each launch in
``sample_point_features.launches``: one a call, four under
``invalid_fill: mean`` (the sampler, the mean's partial sums and their
total, the fill).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from nerf_fewshot_tpu_torch.ops.interp import grid_sample
from nerf_fewshot_tpu_torch.ops.rays import project_points_script, project_points_w2c

View = Union[int, torch.Tensor]
# (per-channel sums (1, Fd) of this call's points, its point count) ->
# (the sums over every rank, the point count over every rank)
BatchSum = Callable[[torch.Tensor, int], Tuple[torch.Tensor, int]]
PROJECTIONS = ("reference", "script")
INVALID_FILLS = ("zeros", "mean")

# csrc/point_features.cu:nerf_point_features(pts, maps, view_ptr, view_imm,
# n_views, poses, focal, half_w, half_h, inv_w, inv_h, map_h, map_w, fd, n,
# script, align_corners, feats, valid, stream)
SAMPLE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_float] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
# nerf_point_features_sums(feats, n, fd, partial, sums, stream)
SUMS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 3
# nerf_point_features_fill(feats, valid, sums, inv_n, n, fd, stream)
FILL_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p])


def select_view(t: torch.Tensor, view: View) -> torch.Tensor:
    """``t[view]``, by ``index_select`` for a tensor index."""
    if isinstance(view, torch.Tensor):
        return t.index_select(0, view.reshape(1))[0]
    return t[view]


def point_features_reference(pts, maps, view: View, pose_mats, focal: float, H: int, W: int, *,
                             align_corners: bool, projection: str, invalid_fill: str,
                             batch_sum: Optional[BatchSum] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(features (N, Fd), valid (N,) bool)``, the
    arithmetic of the trainer's ``_feature_sampler`` on view ``view`` of the
    stacks (``valid = z > 0``; the script projection masks nothing and
    fills nothing). ``batch_sum``: under a mesh, the mean's per-channel sums
    and count over every rank."""
    fmap, pose = select_view(maps, view), select_view(pose_mats, view)
    if projection == "script":
        pts2d, z = project_points_script(pts, pose, focal, H, W)
        return grid_sample(fmap, pts2d, align_corners=align_corners), z > 0
    pts2d, _, valid = project_points_w2c(pts, pose, focal, H, W)
    f = grid_sample(fmap, pts2d, align_corners=align_corners)
    if invalid_fill == "mean":
        if batch_sum is None:
            mean = torch.mean(f, dim=0, keepdim=True)
        else:
            total, n = batch_sum(torch.sum(f, dim=0, keepdim=True), f.shape[0])
            mean = total / n
        f = torch.where(valid[:, None], f, mean)
    return f, valid


def _check(pts, maps, view, pose_mats, projection, invalid_fill) -> None:
    """The wrapper's refusals, on every device."""
    caller = "sample_point_features"
    if projection not in PROJECTIONS or invalid_fill not in INVALID_FILLS:
        raise ValueError(f"{caller}: projection {projection!r} / invalid_fill "
                         f"{invalid_fill!r}; expected one of {PROJECTIONS} / {INVALID_FILLS}")
    device = pts.device
    for t, name, ndim in ((pts, "pts", 2), (maps, "maps", 4), (pose_mats, "pose_mats", 3)):
        if t.requires_grad:
            raise ValueError(f"{caller}: {name} requires grad; the kernel has no backward")
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be a contiguous float32 tensor on {device}; "
                             f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
        if t.dim() != ndim:
            raise ValueError(f"{caller}: {name} has shape {tuple(t.shape)}, expected {ndim} dims")
    V, Hp, Wp, Fd = maps.shape
    if pts.shape[1] != 3 or tuple(pose_mats.shape) != (V, 4, 4) or min(Hp, Wp, Fd) < 1:
        raise ValueError(f"{caller}: pts {tuple(pts.shape)}, maps {tuple(maps.shape)}, "
                         f"pose_mats {tuple(pose_mats.shape)}; expected (N, 3), "
                         f"(V, Hp, Wp, Fd) and (V, 4, 4)")
    if isinstance(view, torch.Tensor):
        if view.device != device or view.dtype != torch.int64 or view.numel() != 1:
            raise ValueError(f"{caller}: a view tensor must hold one int64 on {device}; got "
                             f"{view.numel()} {view.dtype} on {view.device}")
        if device.type == "cpu":  # on a card the kernel traps on an index out of range
            view = int(view)
    elif not isinstance(view, (int, np.integer)):
        raise ValueError(f"{caller}: view {view!r} is neither an int nor an int64 tensor")
    if not isinstance(view, torch.Tensor) and not 0 <= view < V:
        raise ValueError(f"{caller}: view {view} out of range for {V} maps")


def sample_point_features_valid(pts, maps, view: View, pose_mats, focal: float, H: int, W: int,
                                *, align_corners: bool, projection: str, invalid_fill: str,
                                batch_sum: Optional[BatchSum] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(features (N, Fd), valid (N,) bool)`` of ``pts`` (N, 3) in view
    ``view`` of ``maps`` (V, Hp, Wp, Fd) and ``pose_mats`` (V, 4, 4) for an
    HxW image of focal length ``focal``: the plain version on CPU tensors,
    the kernel on CUDA tensors."""
    _check(pts, maps, view, pose_mats, projection, invalid_fill)
    if pts.device.type == "cpu":
        return point_features_reference(
            pts, maps, view, pose_mats, focal, H, W, align_corners=align_corners,
            projection=projection, invalid_fill=invalid_fill, batch_sum=batch_sum)
    from nerf_fewshot_tpu_torch.render.kernels import _check_card, _lib_fn, _raise_on

    device = pts.device
    _check_card(device, "sample_point_features")
    V, Hp, Wp, Fd = maps.shape
    if Fd % 4 == 0 and maps.data_ptr() % 16:
        raise ValueError("sample_point_features: maps must be 16-byte aligned")
    N = pts.shape[0]
    feats = torch.empty((N, Fd), dtype=torch.float32, device=device)
    valid = torch.empty((N,), dtype=torch.bool, device=device)
    if N == 0:
        return feats, valid
    stream = torch.cuda.current_stream(device).cuda_stream
    lib, fn = _lib_fn("point_features", "nerf_point_features", SAMPLE_ARGTYPES)
    tensor_view = isinstance(view, torch.Tensor)
    script = projection == "script"
    err = fn(pts.data_ptr(), maps.data_ptr(), view.data_ptr() if tensor_view else None,
             0 if tensor_view else int(view), V, pose_mats.data_ptr(), focal, W / 2, H / 2,
             float(np.float32(1) / np.float32(W)), float(np.float32(1) / np.float32(H)),
             Hp, Wp, Fd, N, int(script), int(align_corners), feats.data_ptr(), valid.data_ptr(),
             stream)
    _raise_on(err, lib, "point_features")
    sample_point_features.launches += 1
    if script or invalid_fill != "mean":
        return feats, valid
    rows_fn = lib.nerf_point_features_rows_per_slice
    rows_fn.argtypes, rows_fn.restype = [ctypes.c_longlong], ctypes.c_longlong
    slices = -(-N // rows_fn(N))
    partial = torch.empty((slices, Fd), dtype=torch.float64, device=device)
    sums = torch.empty((1, Fd), dtype=torch.float32, device=device)
    _, fn = _lib_fn("point_features", "nerf_point_features_sums", SUMS_ARGTYPES)
    _raise_on(fn(feats.data_ptr(), N, Fd, partial.data_ptr(), sums.data_ptr(), stream), lib,
              "point_features_sums")
    sample_point_features.launches += 2
    n_total = N
    if batch_sum is not None:
        sums, n_total = batch_sum(sums, N)
        sums = sums.contiguous()
    _, fn = _lib_fn("point_features", "nerf_point_features_fill", FILL_ARGTYPES)
    _raise_on(fn(feats.data_ptr(), valid.data_ptr(), sums.data_ptr(),
                 float(np.float32(1) / np.float32(n_total)), N, Fd, stream), lib,
              "point_features_fill")
    sample_point_features.launches += 1
    return feats, valid


def sample_point_features(pts, maps, view: View, pose_mats, focal: float, H: int, W: int, *,
                          align_corners: bool, projection: str, invalid_fill: str,
                          batch_sum: Optional[BatchSum] = None) -> torch.Tensor:
    """The features of ``sample_point_features_valid`` alone."""
    return sample_point_features_valid(
        pts, maps, view, pose_mats, focal, H, W, align_corners=align_corners,
        projection=projection, invalid_fill=invalid_fill, batch_sum=batch_sum)[0]


sample_point_features.launches = 0
