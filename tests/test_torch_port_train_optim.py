"""The port's optimizers, LR schedule and plain training loop against the JAX
package, in float64 so that identical semantics must agree to ~1e-12
(Adam's g/sqrt(v) normalization turns fp32 rounding into O(lr) update
differences wherever a gradient is near zero; in f64 that noise is gone).

- ``make_optimizer``: 10 steps of the same random gradients through the JAX
  optax chain and the port's torch optimizer, for ``adam`` + L2 decay,
  ``adamw`` + decoupled decay and the global-norm clip, with a learning-rate
  change half-way; parameters within rtol 1e-10.
- The loop gate: 8 Adam steps of the port's plain path (``render_rays`` with
  injected jitter uniforms + ``nerf_loss`` + ``make_optimizer``) against the
  JAX XLA path (flax ``NeRFMLP`` + ``volume_render`` + ``nerf_loss`` + the
  optax chain) on the same depths, modelled on
  ``tests/test_full_parity.py::test_multi_step_training_trajectory_allclose``:
  losses within rtol 1e-9, parameters within rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.ops.composite import volume_render as jax_volume_render
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.training import optim as joptim
from nerf_fewshot_tpu.training.losses import nerf_loss as jax_nerf_loss
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.ops.sampling import sample_along_rays
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import optim as toptim
from nerf_fewshot_tpu_torch.training.losses import nerf_loss


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_multistep_lr_matches_jax():
    want = joptim.multistep_lr(5e-4, (100, 150), 0.5)
    got = toptim.multistep_lr(5e-4, (100, 150), 0.5)
    assert [got(e) for e in range(0, 220, 7)] == [want(e) for e in range(0, 220, 7)]
    assert got(99) == 5e-4 and got(100) == 2.5e-4 and got(150) == 1.25e-4


@pytest.mark.parametrize("kind,wd,clip", [("adam", 1e-2, 0.0), ("adamw", 1e-2, 0.0),
                                          ("adam", 1e-3, 0.5), ("adamw", 0.0, 0.5)])
def test_make_optimizer_matches_jax(x64, kind, wd, clip):
    rng = np.random.default_rng(11)
    shapes = {"a": (4, 5), "b": (5,), "c": (3, 2, 2)}
    p0 = {k: rng.standard_normal(s) for k, s in shapes.items()}
    # gradient scales straddle the clip norm (~0.5): some steps clip, some do not
    grads = [{k: rng.standard_normal(s) * (0.02 if i % 3 == 0 else 0.5) for k, s in shapes.items()}
             for i in range(10)]
    lr0, lr1 = 1e-2, 3e-3

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tx = joptim.make_optimizer(jcfg.OptimizerConfig(lr=lr0, weight_decay=wd, kind=kind,
                                                    grad_clip=clip), jp)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = toptim.make_optimizer(tcfg.OptimizerConfig(lr=lr0, weight_decay=wd, kind=kind,
                                                     grad_clip=clip), tp.values())
    clipped = 0
    for i, g in enumerate(grads):
        if i == 5:
            joptim.set_learning_rate(state, lr1)
            toptim.set_learning_rate(opt, lr1)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        if clip:
            clipped += int(np.sqrt(sum(np.sum(v * v) for v in g.values())) >= clip)
            norm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in tp.values())).item()
            assert norm <= clip * (1 + 1e-12)  # the hook clipped the grads in place
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-10,
                                       atol=1e-13, err_msg=f"{k} after step {i}")
    if clip:
        assert 0 < clipped < len(grads)
    assert opt.param_groups[0]["lr"] == lr1


def test_optimizer_refuses_lora_only_and_unknown_kinds():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="LoRA"):
        toptim.make_optimizer(tcfg.OptimizerConfig(), p, lora_only=True)
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        toptim.make_optimizer(tcfg.OptimizerConfig(kind="sgd"), p)


def test_plain_training_loop_matches_jax_in_f64(x64):
    """8 Adam steps (torch semantics: L2 decay before the moments) of the
    port's plain path against the JAX XLA path, on a fixed ray batch with a
    masked tail and fresh jitter uniforms every step."""
    R, S, H, L = 32, 24, 64, 3
    lr, wd = 5e-3, 1e-4
    rng = np.random.default_rng(77)
    ro = rng.standard_normal((R, 3))
    rd = rng.standard_normal((R, 3))
    tgt = rng.uniform(0, 1, (R, 3))
    mask = (np.arange(R) < 27).astype(np.float64)
    uniforms = [rng.uniform(0, 1, (R, S)) for _ in range(8)]

    model_j = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=H, num_layers=L)
    params = model_j.init(jax.random.key(0), jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"]
    # fp32-representable start values, so that both sides start bit-equal
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32).astype(np.float64)), params)
    model_t = NeRFMLP(10, 4, True, hidden_dim=H, num_layers=L).double()
    model_t.load_state_dict({k: v.double() for k, v in nerf_mlp_from_jax(params).items()})

    ocfg = dict(lr=lr, weight_decay=wd, kind="adam", grad_clip=0.0)
    tx = joptim.make_optimizer(jcfg.OptimizerConfig(**ocfg), params)
    opt_state = tx.init(params)
    opt = toptim.make_optimizer(tcfg.OptimizerConfig(**ocfg), model_t.parameters())
    settings = RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=True)
    t = lambda a: torch.tensor(a, dtype=torch.float64)

    @jax.jit
    def jax_step(params, opt_state, z_vals):
        def loss_fn(p):
            pts = jnp.asarray(ro)[:, None] + jnp.asarray(rd)[:, None] * z_vals[..., None]
            dirs = jnp.broadcast_to(jnp.asarray(rd)[:, None], (R, S, 3))
            rgb, sigma = model_j.apply({"params": p}, pts.reshape(-1, 3), dirs.reshape(-1, 3))
            out = jax_volume_render(rgb.reshape(R, S, 3), sigma.reshape(R, S), z_vals,
                                    jnp.asarray(rd))
            return jax_nerf_loss(out.rgb, jnp.asarray(tgt), jcfg.LossConfig(),
                                 mask=jnp.asarray(mask))["total"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    j_losses, t_losses = [], []
    for u in uniforms:
        _, z = sample_along_rays(t(ro), t(rd), 2.0, 6.0, S, uniforms=t(u))
        params, opt_state, loss = jax_step(params, opt_state, jnp.asarray(z.numpy()))
        j_losses.append(float(loss))

        out = render_rays(model_t, t(ro), t(rd), settings, uniforms=t(u))
        loss_t = nerf_loss(out.rgb, t(tgt), tcfg.LossConfig(), mask=t(mask))["total"]
        opt.zero_grad()
        loss_t.backward()
        opt.step()
        t_losses.append(loss_t.item())

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-9, atol=1e-12)
    assert t_losses[-1] < 0.9 * t_losses[0], "the loop did not descend"
    for k, v in model_t.state_dict().items():
        np.testing.assert_allclose(v.numpy(), _leaf(params, k), rtol=1e-8, atol=1e-10, err_msg=k)


def _leaf(params, name):
    """The JAX leaf of a port state-dict name, laid out (out, in)."""
    mod, kind = name.rsplit(".", 1)
    key = mod.replace("trunk.", "trunk_")
    leaf = params[key]["kernel" if kind == "weight" else "bias"]
    return np.asarray(leaf).T if kind == "weight" else np.asarray(leaf)
