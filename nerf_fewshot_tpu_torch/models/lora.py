"""torch-default ``nn.Linear`` initialisation from an explicit generator,
and the LoRA adapter (counterpart of ``TorchDense`` / ``torch_linear_init``
/ ``LoRADense`` in ``nerf_fewshot_tpu/models/lora.py``; ``lora_label_fn``
comes with trunk LoRA).

``nn.Linear``'s default init is ``kaiming_uniform(a=sqrt(5))`` on the
weight, which reduces to ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``, and the
same bound on the bias. Drawing both from a caller's ``torch.Generator``
makes a model's initial weights a function of its seed alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def torch_linear_init_(
    weight: torch.Tensor, generator: Optional[torch.Generator] = None, scale: float = 1.0
) -> torch.Tensor:
    """In place ``U(-scale/sqrt(fan_in), +scale/sqrt(fan_in))`` on an
    (out, in) weight."""
    bound = scale / math.sqrt(weight.shape[1])
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def torch_bias_init_(
    bias: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """In place ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return bias.uniform_(-bound, bound, generator=generator)


def torch_dense(
    in_features: int,
    out_features: int,
    generator: Optional[torch.Generator] = None,
    bias_value: Optional[float] = None,
) -> nn.Linear:
    """An ``nn.Linear`` with torch's default distribution drawn from
    ``generator`` (a CPU generator: build on the CPU, then move the
    module). ``bias_value`` replaces the random bias with a constant."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    torch_linear_init_(layer.weight, generator)
    if bias_value is None:
        torch_bias_init_(layer.bias, in_features, generator)
    else:
        with torch.no_grad():
            layer.bias.fill_(float(bias_value))
    return layer


class LoRADense(nn.Module):
    """A dense layer with a rank-``r`` update:
    ``base(x) + (alpha / r) * dropout(x @ lora_a) @ lora_b``.

    ``lora_a`` (in, r) is ``kaiming_uniform(a=sqrt(5))``, i.e.
    ``U(-1/sqrt(in), +1/sqrt(in))``, and ``lora_b`` (r, out) starts at zero,
    both in the JAX layout. The dropout is active in training mode only
    (the JAX module's ``deterministic=False``). ``rank`` 0 is the plain
    base layer."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 alpha: float = 16.0, dropout_rate: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.base = torch_dense(in_features, out_features, generator)
        if rank > 0:
            bound = math.sqrt(6.0 / ((1.0 + 5.0) * in_features))
            a = torch.empty(in_features, rank).uniform_(-bound, bound, generator=generator)
            self.lora_a = nn.Parameter(a)
            self.lora_b = nn.Parameter(torch.zeros(rank, out_features))
            self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base = self.base(x)
        if self.rank <= 0:
            return base
        return base + (self.alpha / self.rank) * (self.dropout(x @ self.lora_a) @ self.lora_b)
