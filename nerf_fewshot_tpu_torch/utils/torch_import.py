"""Reference PyTorch checkpoints into the port's models (counterpart of
``nerf_fewshot_tpu/utils/torch_import.py``).

The reference saves its NeRF weights under ``nerf_model_state_dict``
(its config-driven trainer) or ``nerf_state_dict`` (its multi-scale
trainer), or as a bare state dict. Its layouts map onto the port's:

* the functional MLP: the trunk as ``layers.{i}`` or ``trunk.{i}`` (a LoRA
  layer's base under ``.original``, its pair as the bias-free Linears
  ``lora_A`` (r, in) and ``lora_B`` (out, r), whose weights transpose into
  ``lora_a`` (in, r) and ``lora_b`` (r, out)), the heads as ``sigma_out`` /
  ``rgb_out``;
* ``NeRFWithDINO``: the Sequential indices of its fusion, attention,
  density and colour stacks (ReLUs between the Linears, hence 0, 2, 4).

Linear weights are (out, in) in both frameworks here, so only the LoRA
pair is transposed. Entries the mapping does not match keep the model's
current values, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

State = Dict[str, torch.Tensor]


def load_torch_checkpoint(path: str) -> Any:
    """``torch.load`` of a reference file on the CPU. ``weights_only``: the
    file comes from outside the program, so only tensors and plain
    containers are unpickled."""
    return torch.load(path, map_location="cpu", weights_only=True)


def model_state_dict(ckpt: Any) -> Mapping[str, torch.Tensor]:
    """The NeRF state dict of a reference checkpoint: under
    ``nerf_model_state_dict``, under ``nerf_state_dict``, or the file itself."""
    if isinstance(ckpt, dict):
        for key in ("nerf_model_state_dict", "nerf_state_dict"):
            if key in ckpt:
                return ckpt[key]
    return ckpt


def _put_linear(state: State, prefix: str, sd: Mapping, ref_prefix: str) -> None:
    for p in ("weight", "bias"):
        if f"{ref_prefix}.{p}" in sd:
            state[f"{prefix}.{p}"] = sd[f"{ref_prefix}.{p}"]


def _f32_copy(state: State) -> State:
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).clone()
            for k, v in state.items()}


def import_nerf_mlp_state_dict(state: Mapping[str, torch.Tensor], sd: Mapping) -> State:
    """A reference functional-MLP state dict mapped onto a ``NeRFMLP``
    state dict ``state`` (dense or LoRA trunk); returns the new state dict."""
    out = dict(state)
    i = 0
    while f"trunk.{i}.weight" in out or f"trunk.{i}.base.weight" in out:
        ref = next((c for c in (f"layers.{i}", f"trunk.{i}")
                    if f"{c}.weight" in sd or f"{c}.original.weight" in sd), None)
        if ref is None:
            break
        if f"trunk.{i}.base.weight" in out:  # LoRADense
            base = f"{ref}.original" if f"{ref}.original.weight" in sd else ref
            _put_linear(out, f"trunk.{i}.base", sd, base)
            if f"{ref}.lora_A.weight" in sd:
                out[f"trunk.{i}.lora_a"] = sd[f"{ref}.lora_A.weight"].T
                out[f"trunk.{i}.lora_b"] = sd[f"{ref}.lora_B.weight"].T
        else:
            _put_linear(out, f"trunk.{i}", sd, ref)
        i += 1
    _put_linear(out, "sigma_head", sd, "sigma_out")
    _put_linear(out, "rgb_head", sd, "rgb_out")
    return _f32_copy(out)


def import_nerf_with_dino_state_dict(state: Mapping[str, torch.Tensor], sd: Mapping) -> State:
    """A reference ``NeRFWithDINO`` state dict mapped onto the port's
    ``NeRFWithDINO`` state dict ``state``; returns the new state dict."""
    out = dict(state)
    pairs = [("dino_fusion.fusion_0", "dino_fusion.fusion.0"),
             ("dino_fusion.fusion_1", "dino_fusion.fusion.2"),
             ("dino_fusion.attention_0", "dino_fusion.attention.0"),
             ("dino_fusion.attention_1", "dino_fusion.attention.2"),
             ("dino_fusion.output_proj", "dino_fusion.output_proj"),
             ("density_mlp.density_head", "density_mlp.density_head"),
             ("density_mlp.feature_head", "density_mlp.feature_head"),
             ("color_mlp.layer_0", "color_mlp.color_layers.0"),
             ("color_mlp.layer_1", "color_mlp.color_layers.2"),
             ("color_mlp.rgb", "color_mlp.color_layers.4")]
    i = 0
    while f"density_mlp.density_layers.{2 * i}.weight" in sd:
        pairs.append((f"density_mlp.layers.{i}", f"density_mlp.density_layers.{2 * i}"))
        i += 1
    for prefix, ref in pairs:
        _put_linear(out, prefix, sd, ref)
    return _f32_copy(out)
