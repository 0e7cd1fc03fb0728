"""Attention-weighted fusion of the positional encoding with DINO features
(counterpart of ``nerf_fewshot_tpu/models/fusion.py:NeRFDINOFusion``).

One fusion MLP, applied twice with shared weights: to ``[pos | dino]``,
then, after a 2-way softmax attention over (pos, dino) computed from the
first result, to the re-weighted original inputs; an output projection
follows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_fewshot_tpu_torch.models.lora import torch_dense


class NeRFDINOFusion(nn.Module):
    """``forward(pos_encoding (N, pos_dim), dino (N, dino_dim)) -> (N,
    hidden_dim)``. Layer names follow the JAX module's (``fusion_0``,
    ``fusion_1``, ``attention_0``, ``attention_1``, ``output_proj``)."""

    def __init__(self, pos_dim: int, dino_dim: int, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fusion_0 = torch_dense(pos_dim + dino_dim, hidden_dim, generator)
        self.fusion_1 = torch_dense(hidden_dim, hidden_dim, generator)
        self.attention_0 = torch_dense(hidden_dim, hidden_dim // 4, generator)
        self.attention_1 = torch_dense(hidden_dim // 4, 2, generator)
        self.output_proj = torch_dense(hidden_dim, hidden_dim, generator)

    def _fusion(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fusion_1(torch.relu(self.fusion_0(x))))

    def forward(self, pos_encoding: torch.Tensor, dino: torch.Tensor) -> torch.Tensor:
        fused = self._fusion(torch.cat([pos_encoding, dino], dim=-1))
        att = torch.relu(self.attention_0(fused))
        weights = torch.softmax(self.attention_1(att), dim=-1)
        final = self._fusion(torch.cat([pos_encoding * weights[..., 0:1],
                                        dino * weights[..., 1:2]], dim=-1))
        return self.output_proj(final)
