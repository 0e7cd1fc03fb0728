"""The port's NeRFMLP against the JAX one on weights carried over with
``nerf_mlp_from_jax``.

Tolerance: fp32 matmuls summed in different orders over a 90- or
128-wide input and a 128-wide trunk: rtol 1e-5, atol 2e-5 on rgb (in
[0, 1]) and on the raw sigma (O(1) here).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu_torch.models.lora import torch_dense
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax

RNG = np.random.default_rng(21)


def _jax_params(use_viewdirs, sigma_bias, seed=0, lora_rank=0, **kw):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=use_viewdirs,
                       hidden_dim=128, num_layers=3, sigma_bias_init=sigma_bias,
                       lora_rank=lora_rank, **kw)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("use_viewdirs,sigma_bias", [(True, None), (True, 0.1), (False, None)])
def test_nerf_mlp_matches_jax_on_transplanted_weights(use_viewdirs, sigma_bias):
    jmodel, params = _jax_params(use_viewdirs, sigma_bias)
    pts = RNG.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    dirs = RNG.standard_normal((64, 3)).astype(np.float32)
    rgb_j, sig_j = jmodel.apply({"params": params}, jnp.asarray(pts), jnp.asarray(dirs))

    model = NeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=use_viewdirs, hidden_dim=128,
                    num_layers=3, sigma_bias_init=sigma_bias)
    model.load_state_dict(nerf_mlp_from_jax(params))
    with torch.no_grad():
        rgb_t, sig_t = model(torch.from_numpy(pts), torch.from_numpy(dirs))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5, atol=2e-5)


def test_nerf_mlp_from_jax_transposes_every_kernel():
    _, params = _jax_params(True, None)
    state = nerf_mlp_from_jax(params)
    assert sorted(state) == sorted(
        [f"trunk.{i}.{p}" for i in range(3) for p in ("weight", "bias")]
        + [f"{h}.{p}" for h in ("sigma_head", "rgb_head") for p in ("weight", "bias")]
    )
    np.testing.assert_array_equal(state["trunk.1.weight"].numpy(), params["trunk_1"]["kernel"].T)
    np.testing.assert_array_equal(state["rgb_head.bias"].numpy(), params["rgb_head"]["bias"])


def test_nerf_mlp_from_jax_refuses_lora_trees():
    """LoRA trees are ported now: each trunk layer maps to ``base`` (kernel
    transposed) and its ``lora_a`` (in, r) / ``lora_b`` (r, out) pair kept in
    the JAX layout; a layer that is neither dense nor LoRA is refused."""
    _, params = _jax_params(True, None, lora_rank=4)
    state = nerf_mlp_from_jax(params)
    np.testing.assert_array_equal(state["trunk.1.base.weight"].numpy(),
                                  params["trunk_1"]["base"]["kernel"].T)
    np.testing.assert_array_equal(state["trunk.2.lora_a"].numpy(), params["trunk_2"]["lora_a"])
    assert state["trunk.0.lora_b"].shape == (4, 128)
    NeRFMLP(use_viewdirs=True, hidden_dim=128, num_layers=3, lora_rank=4).load_state_dict(state)
    with pytest.raises(ValueError, match="neither"):
        nerf_mlp_from_jax({**params, "trunk_0": {"scale": params["rgb_head"]["bias"]}})


@pytest.mark.parametrize("kwargs", [{"dino_dim": 64, "lora_rank": 4}, {"skip_layers": (1,)},
                                    {"lora_rank": 4}])
def test_nerf_mlp_refuses_unported_options(kwargs):
    """Trunk LoRA and skip layers are ported now: the options the port
    refused before build the JAX module's parameter shapes."""
    jm = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=128, num_layers=3,
                    **kwargs)
    ins = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, 64))] if "dino_dim" in kwargs
                                                    else [])
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), *ins)["params"])
    model = NeRFMLP(use_viewdirs=True, hidden_dim=128, num_layers=3, **kwargs)
    want = nerf_mlp_from_jax(params)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_torch_default_init_from_generator():
    """U(+-1/sqrt(fan_in)) on weight and bias, as nn.Linear and the JAX
    TorchDense draw them; the same seed gives the same layer, a constant
    sigma bias overrides the draw."""
    a = torch_dense(90, 256, torch.Generator().manual_seed(3))
    b = torch_dense(90, 256, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.weight.detach().numpy(), b.weight.detach().numpy())
    bound = 1.0 / math.sqrt(90)
    for t in (a.weight, a.bias):
        assert t.abs().max().item() <= bound
        assert t.abs().max().item() > 0.9 * bound  # spread over the whole interval
    # the JAX TorchDense bound, for the same fan_in
    _, params = _jax_params(True, None)
    assert np.abs(params["trunk_0"]["kernel"]).max() <= bound
    m = NeRFMLP(use_viewdirs=True, hidden_dim=128, num_layers=3, sigma_bias_init=0.1,
                generator=torch.Generator().manual_seed(0))
    assert torch.all(m.sigma_head.bias == 0.1)
