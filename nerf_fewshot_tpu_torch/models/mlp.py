"""The functional-stack NeRF MLP (counterpart of
``nerf_fewshot_tpu/models/mlp.py:NeRFMLP``).

Input per point: ``[PE(pos)] (+ [PE(dir)] if use_viewdirs) (+ [feats] if
dino_dim > 0)``, features last; an n-layer ReLU trunk; an rgb (sigmoid)
head and a raw (pre-ReLU) sigma head. Skip connections and trunk LoRA come
with a later slice and are refused here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nerf_fewshot_tpu_torch.models.lora import torch_dense
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding, posenc_output_dim


class NeRFMLP(nn.Module):
    """``forward(pts (N,3), dirs (N,3), dino (N,dino_dim)) -> (rgb (N,3),
    sigma (N,1))``.

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
        sigma_bias_init: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if tuple(skip_layers):
            raise NotImplementedError("NeRFMLP: skip_layers are not ported yet")
        if lora_rank > 0:
            raise NotImplementedError("NeRFMLP: trunk LoRA is not ported yet")
        self.pos_freq = pos_freq
        self.dir_freq = dir_freq
        self.use_viewdirs = use_viewdirs
        self.dino_dim = dino_dim
        in_dim = posenc_output_dim(3, pos_freq) + dino_dim
        if use_viewdirs:
            in_dim += posenc_output_dim(3, dir_freq)
        dims = [in_dim] + [hidden_dim] * num_layers
        self.trunk = nn.ModuleList(
            torch_dense(dims[i], dims[i + 1], generator) for i in range(num_layers)
        )
        self.sigma_head = torch_dense(hidden_dim, 1, generator, bias_value=sigma_bias_init)
        self.rgb_head = torch_dense(hidden_dim, 3, generator)

    def forward(
        self, pts: torch.Tensor, dirs: Optional[torch.Tensor] = None,
        dino: Optional[torch.Tensor] = None,
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
        h = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        for layer in self.trunk:
            h = torch.relu(layer(h))
        return torch.sigmoid(self.rgb_head(h)), self.sigma_head(h)


def nerf_mlp_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``NeRFMLP`` param tree (``trunk_i/{kernel (in,out), bias}``,
    ``sigma_head``, ``rgb_head``, numpy arrays) -> this module's state
    dict, each kernel transposed to (out, in). LoRA trees are refused."""

    def linear(prefix: str, layer: Mapping) -> Dict[str, torch.Tensor]:
        if "kernel" not in layer:
            raise NotImplementedError(
                f"{prefix}: LoRA / non-Dense param trees are not ported yet "
                f"(keys {sorted(layer)})"
            )
        kernel = np.asarray(layer["kernel"], np.float32)
        return {
            f"{prefix}.weight": torch.tensor(kernel.T),
            f"{prefix}.bias": torch.tensor(np.asarray(layer["bias"], np.float32)),
        }

    state: Dict[str, torch.Tensor] = {}
    n_trunk = sum(1 for k in params if k.startswith("trunk_"))
    for i in range(n_trunk):
        state.update(linear(f"trunk.{i}", params[f"trunk_{i}"]))
    state.update(linear("sigma_head", params["sigma_head"]))
    state.update(linear("rgb_head", params["rgb_head"]))
    return state
