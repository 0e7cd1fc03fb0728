"""The NeRF MLPs (counterpart of ``nerf_fewshot_tpu/models/mlp.py``).

``NeRFMLP`` is the functional stack. Input per point: ``[PE(pos)] (+
[PE(dir)] if use_viewdirs) (+ [feats] if dino_dim > 0)``, features last; an
n-layer ReLU trunk, with the encoded input concatenated again before each
layer in ``skip_layers`` and, with ``lora_rank > 0``, a rank-r LoRA update
on every trunk layer; an rgb (sigmoid) head and a raw (pre-ReLU) sigma head.

``NeRFWithDINO`` is the module stack: ``NeRFDINOFusion`` of the position
encoding with the DINO features, a ``DensityMLP`` trunk with a ReLU'd
density head and a feature head, and a view-dependent ``ColorMLP``. Its
density is ReLU'd; the renderer applies ReLU again, which changes nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nerf_fewshot_tpu_torch.models.fusion import NeRFDINOFusion
from nerf_fewshot_tpu_torch.models.lora import LoRADense, torch_dense
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding, posenc_output_dim


class NeRFMLP(nn.Module):
    """``forward(pts (N,3), dirs (N,3), dino (N,dino_dim), deterministic=True)
    -> (rgb (N,3), sigma (N,1))``.

    ``skip_layers``: trunk layers ``i > 0`` whose input is ``[h | x]``, the
    encoded input ``x`` appended. ``lora_rank > 0`` makes every trunk layer
    a ``LoRADense`` (``trunk.{i}.base``, ``trunk.{i}.lora_a``,
    ``trunk.{i}.lora_b``) with ``lora_alpha`` and ``lora_dropout``; the
    dropout acts only when ``forward`` is called with ``deterministic=False``,
    as in the JAX module, whose trainer never does so.
    ``sigma_bias_init`` sets the sigma-head bias to a constant (a live
    start: a negative random bias can leave relu(sigma) zero everywhere).
    Parameters are drawn from ``generator`` on the CPU; move the module
    to its device afterwards.
    """

    def __init__(
        self,
        pos_freq: int = 10,
        dir_freq: int = 4,
        use_viewdirs: bool = False,
        dino_dim: int = 0,
        hidden_dim: int = 256,
        num_layers: int = 8,
        skip_layers: Sequence[int] = (),
        lora_rank: int = 0,
        lora_alpha: float = 16.0,
        lora_dropout: float = 0.1,
        sigma_bias_init: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.pos_freq = pos_freq
        self.dir_freq = dir_freq
        self.use_viewdirs = use_viewdirs
        self.dino_dim = dino_dim
        self.skip_layers = tuple(i for i in skip_layers if i > 0)
        in_dim = posenc_output_dim(3, pos_freq) + dino_dim
        if use_viewdirs:
            in_dim += posenc_output_dim(3, dir_freq)
        trunk = []
        for i in range(num_layers):
            fan_in = in_dim if i == 0 else hidden_dim
            if i in self.skip_layers:
                fan_in += in_dim
            if lora_rank > 0:
                trunk.append(LoRADense(fan_in, hidden_dim, rank=lora_rank, alpha=lora_alpha,
                                       dropout_rate=lora_dropout, generator=generator))
            else:
                trunk.append(torch_dense(fan_in, hidden_dim, generator))
        self.trunk = nn.ModuleList(trunk)
        self.sigma_head = torch_dense(hidden_dim, 1, generator, bias_value=sigma_bias_init)
        self.rgb_head = torch_dense(hidden_dim, 3, generator)

    def forward(
        self, pts: torch.Tensor, dirs: Optional[torch.Tensor] = None,
        dino: Optional[torch.Tensor] = None, deterministic: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        parts = [positional_encoding(pts, self.pos_freq)]
        if self.use_viewdirs:
            if dirs is None:
                raise ValueError("use_viewdirs=True requires dirs")
            parts.append(positional_encoding(dirs, self.dir_freq))
        if self.dino_dim > 0:
            if dino is None:
                raise ValueError(f"dino_dim={self.dino_dim} requires dino features")
            parts.append(dino)
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        h = x
        for i, layer in enumerate(self.trunk):
            if i in self.skip_layers:
                h = torch.cat([h, x], dim=-1)
            if isinstance(layer, LoRADense):
                h = torch.relu(layer(h, deterministic=deterministic))
            else:
                h = torch.relu(layer(h))
        return torch.sigmoid(self.rgb_head(h)), self.sigma_head(h)


class DensityMLP(nn.Module):
    """``forward(x (N, H)) -> (density (N, 1), features (N, H))``: a ReLU
    trunk, a ReLU'd density head and a feature head."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_layers: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            torch_dense(in_dim if i == 0 else hidden_dim, hidden_dim, generator)
            for i in range(num_layers))
        self.density_head = torch_dense(hidden_dim, 1, generator)
        self.feature_head = torch_dense(hidden_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
        return torch.relu(self.density_head(h)), self.feature_head(h)


class ColorMLP(nn.Module):
    """``forward(features (N, F), dir_enc (N, Dd)) -> rgb (N, 3)``: two
    ReLU layers of ``hidden_dim`` and ``hidden_dim // 2``, a sigmoid head."""

    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_0 = torch_dense(in_dim, hidden_dim, generator)
        self.layer_1 = torch_dense(hidden_dim, hidden_dim // 2, generator)
        self.rgb = torch_dense(hidden_dim // 2, 3, generator)

    def forward(self, features: torch.Tensor, dir_enc: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.layer_0(torch.cat([features, dir_enc], dim=-1)))
        h = torch.relu(self.layer_1(h))
        return torch.sigmoid(self.rgb(h))


class NeRFWithDINO(nn.Module):
    """``forward(positions (N,3), directions (N,3), dino (N,dino_dim)) ->
    (rgb (N,3), density (N,1))``: fusion -> density trunk -> colour head,
    the density ReLU'd. Parameters are drawn from ``generator`` on the CPU."""

    def __init__(self, pos_freq: int = 10, dir_freq: int = 4, dino_dim: int = 64,
                 hidden_dim: int = 256, num_density_layers: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pos_freq, self.dir_freq = pos_freq, dir_freq
        self.dino_fusion = NeRFDINOFusion(posenc_output_dim(3, pos_freq), dino_dim, hidden_dim,
                                          generator)
        self.density_mlp = DensityMLP(hidden_dim, hidden_dim, num_density_layers, generator)
        self.color_mlp = ColorMLP(hidden_dim + posenc_output_dim(3, dir_freq), hidden_dim // 2,
                                  generator)

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                dino: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if dino is None:
            raise ValueError("NeRFWithDINO requires dino features")
        fused = self.dino_fusion(positional_encoding(positions, self.pos_freq), dino)
        density, features = self.density_mlp(fused)
        rgb = self.color_mlp(features, positional_encoding(directions, self.dir_freq))
        return rgb, density


def _linear_from_jax(prefix: str, layer: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX dense layer (``{kernel (in, out), bias}``) or LoRA layer
    (``{base: {kernel, bias}, lora_a (in, r), lora_b (r, out)}``) -> state
    dict entries under ``prefix``: kernels transposed to (out, in), the LoRA
    pair kept in its JAX layout, as ``LoRADense`` stores it."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    if "base" not in layer and "kernel" not in layer:
        raise ValueError(f"{prefix}: neither a dense nor a LoRA layer (keys {sorted(layer)})")
    if "base" in layer:
        return {**_linear_from_jax(f"{prefix}.base", layer["base"]),
                f"{prefix}.lora_a": f32(layer["lora_a"]), f"{prefix}.lora_b": f32(layer["lora_b"])}
    return {f"{prefix}.weight": f32(np.asarray(layer["kernel"]).T),
            f"{prefix}.bias": f32(layer["bias"])}


def nerf_mlp_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``NeRFMLP`` param tree (``trunk_i`` dense or LoRA layers, skip
    layers' widened kernels included, ``sigma_head``, ``rgb_head``; numpy
    leaves) -> this module's state dict."""
    state: Dict[str, torch.Tensor] = {}
    n_trunk = sum(1 for k in params if k.startswith("trunk_"))
    for i in range(n_trunk):
        state.update(_linear_from_jax(f"trunk.{i}", params[f"trunk_{i}"]))
    state.update(_linear_from_jax("sigma_head", params["sigma_head"]))
    state.update(_linear_from_jax("rgb_head", params["rgb_head"]))
    return state


def nerf_with_dino_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``NeRFWithDINO`` param tree (``dino_fusion``, ``density_mlp``,
    ``color_mlp``; numpy leaves) -> this module's state dict."""
    state: Dict[str, torch.Tensor] = {}
    for name, layer in params["dino_fusion"].items():
        state.update(_linear_from_jax(f"dino_fusion.{name}", layer))
    dm = params["density_mlp"]
    n_layers = sum(1 for k in dm if k.startswith("layer_"))
    for i in range(n_layers):
        state.update(_linear_from_jax(f"density_mlp.layers.{i}", dm[f"layer_{i}"]))
    for head in ("density_head", "feature_head"):
        state.update(_linear_from_jax(f"density_mlp.{head}", dm[head]))
    for name, layer in params["color_mlp"].items():
        state.update(_linear_from_jax(f"color_mlp.{name}", layer))
    return state
