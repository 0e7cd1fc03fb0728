"""Hierarchical sampling of the port against the JAX package: the
inverse-CDF sampler (``_searchsorted_right``, ``sample_pdf``,
``hierarchical_sample``), the plain pipeline's coarse + fine pass
(``render_rays``), the hierarchical training objective
(``fused_train_loss_grad``, whose CPU route is the plain version of the CUDA
kernels, with the coarse pass through kernel 2's or kernel 4's plain
version) against the JAX function running its Pallas kernels in interpret
mode, and a hierarchical ``Trainer`` against the JAX trainer.

The uniforms: the JAX functions draw theirs from a key; the test draws the
same numbers with ``jax.random`` from the same split keys and hands them to
the port, so both sides sample the same depths.

Tolerances, with their reasons:
- ``sample_pdf`` / ``hierarchical_sample``: 1e-5 abs on depths in [2, 6]
  (the fp32 ``cumsum`` of the pdf runs in another order than XLA's scan; a
  one-ulp change of a CDF entry moves a sample by at most ulp/denominator
  times its bin width);
- render outputs: the forward tolerances of the render-kernel test (rtol
  2e-4, atol 2e-5; depth atol 2e-4): fp32 sums in another order, and the
  fine samples follow the coarse weights;
- the objective: loss rtol 1e-5, gradients each leaf within rtol 1e-3 /
  atol 1e-6 of its scale and the whole vector within rel 1e-4, as in
  ``test_torch_port_train_objective.py`` (measured ~9e-6 with deterministic
  samples); trainer epoch losses rtol 1e-4.
- the objective with perturbed (random) samples: the gradient vector within
  rel 5e-3 and no single element compared (measured 1.4e-3 and 2.3e-3).
  The coarse weights of the two routes differ by ~1e-6 (kernel 2's plain
  version against the JAX kernel's triangular-matmul scan), and the
  inverse CDF moves an importance sample in a near-empty bin by up to
  ~1e-5 (measured 9.5e-6; 4.8e-7 from identical coarse weights). The top PE
  band (2^9 rad per unit) turns that into phase changes of ~5e-3 rad, so
  the first layer's gradient moves by ~1e-3 while the loss agrees to 1e-5.
  The port against itself, 1e-7 apart in the importance uniforms, moves
  the same way (rel 7e-6 for a 1.4e-6 depth change, 1.7e-3 for 1.4e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.ops import sampling as js
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu.render.pipeline import render_rays as jax_render_rays
from nerf_fewshot_tpu.render.train_kernel import fused_train_loss_grad as jax_loss_grad
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.ops import sampling as ts
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

HIDDEN, N_LAYERS = 128, 3
R, S, NI = 16, 16, 16
OUT_TOL = dict(rgb=(2e-4, 2e-5), depth=(2e-4, 2e-4), acc=(2e-4, 2e-5), weights=(2e-4, 2e-5))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_params(seed=0, sigma_bias=0.1):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=HIDDEN,
                       num_layers=N_LAYERS, sigma_bias_init=sigma_bias)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _coarse(seed, zero_bins=3):
    """Sorted jittered depths in [2, 6] and weights with some all-zero bins
    (where the < 1e-5 denominator guard fires) and one peak."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 0.2, (R, S)).astype(np.float32)
    w[:, :zero_bins] = 0.0
    w[np.arange(R), rng.integers(zero_bins, S, R)] += 0.8
    return z, w


def _uniforms(kind, key):
    if kind == "linspace":
        return None
    return np.asarray(jax.random.uniform(key, (R, NI)))


@pytest.mark.parametrize("kind", ["random", "linspace"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_matches_jax(kind, seed):
    """Random uniforms and the evenly spaced ``linspace(0, 1)`` (whose ends,
    0 and 1.0, exercise the bracket's clamp to ``cdf[S]`` / ``z[S-1]``)."""
    z, w = _coarse(seed)
    key = jax.random.key(seed)
    want = js.sample_pdf(jnp.asarray(z), jnp.asarray(w), NI,
                         key=None if kind == "linspace" else key)
    u = _uniforms(kind, key)
    got = ts.sample_pdf(_t(z), _t(w), NI, None if u is None else _t(u))
    assert got.shape == (R, NI)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if kind == "linspace":  # u = 1.0 lands on the last depth
        np.testing.assert_array_equal(got[:, -1].numpy(), z[:, -1])


def test_sample_pdf_edges_match_jax():
    """u exactly 0, exactly 1, and on CDF entries (ties); weights all zero
    on a ray (a uniform pdf) and concentrated on one bin (the guard fires in
    every other bin).

    Not compared: a tie at the upper end of a bin whose weight is below the
    floor. There the reference function itself jumps by a bin width within
    one ulp of u (the guard replaces the bin's denominator by 1), and the two
    frameworks' fp32 pdfs and CDFs differ by an ulp (XLA's reduce-window
    cumsum and its division against torch's), so either side of the jump is
    right."""
    z, w = _coarse(3)
    w[0] = 0.0
    w[1] = 0.0
    w[1, 7] = 1.0
    wj = w + 1e-5
    cdf = np.concatenate([np.zeros((R, 1)), np.cumsum(wj / wj.sum(-1, keepdims=True), -1)], -1)
    u = np.random.default_rng(4).uniform(0, 1, (R, NI)).astype(np.float32)
    u[:, 0], u[:, 1] = 0.0, 1.0
    u[:, 2] = cdf[:, 5].astype(np.float32)  # the end of bin 4, which has weight
    u[1, 2] = cdf[1, 8].astype(np.float32)  # ray 1: the end of its one weighted bin
    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape, dtype=None: jnp.asarray(u)
        want = js.sample_pdf(jnp.asarray(z), jnp.asarray(w), NI, key=jax.random.key(0))
    finally:
        jax.random.uniform = orig
    got = ts.sample_pdf(_t(z), _t(w), NI, _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, 0].numpy(), z[:, 0])


def test_searchsorted_right_matches_jax():
    rng = np.random.default_rng(5)
    cdf = np.sort(rng.uniform(0, 1, (R, S + 1)), axis=-1).astype(np.float32)
    cdf[:, 0] = 0.0
    u = rng.uniform(0, 1, (R, NI)).astype(np.float32)
    u[:, :4] = cdf[:, [0, 3, 8, S]]  # ties count as <= u
    want = js._searchsorted_right(jnp.asarray(cdf), jnp.asarray(u))
    got = ts._searchsorted_right(_t(cdf), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "linspace"])
def test_hierarchical_sample_matches_jax(kind):
    z, w = _coarse(6)
    rng = np.random.default_rng(6)
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    key = jax.random.key(6)
    want_pts, want_z = js.hierarchical_sample(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(w), NI,
        key=None if kind == "linspace" else key)
    u = _uniforms(kind, key)
    got_pts, got_z = ts.hierarchical_sample(_t(ro), _t(rd), _t(z), _t(w), NI,
                                            None if u is None else _t(u))
    assert got_z.shape == (R, S + NI) and got_pts.shape == (R, S + NI, 3)
    assert bool(torch.all(got_z[:, 1:] >= got_z[:, :-1]))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), rtol=0, atol=1e-4)


def _rays(seed, n=R):
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    return ro, rd, rng


def _assert_outputs_close(got, want):
    for name in ("rgb", "depth", "acc", "weights"):
        rtol, atol = OUT_TOL[name]
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_rays_hierarchical_matches_jax(perturb, white_bkgd):
    """The plain coarse + fine pass: the JAX ``render_rays`` with a key
    (its four split keys: stratified, noise, importance, noise) against the
    port's with the same uniforms; the fine outputs are returned."""
    jmodel, params = _jax_params()
    ro, rd, _ = _rays(7)
    key = jax.random.key(7)
    js_settings = JaxRenderSettings(n_samples=S, n_importance=NI, perturb=perturb,
                                    white_bkgd=white_bkgd)
    want = jax_render_rays(lambda p, d, f: jmodel.apply({"params": params}, p, d),
                           jnp.asarray(ro), jnp.asarray(rd), js_settings, key=key)
    k_strat, _, k_imp, _ = jax.random.split(key, 4)
    u = np.asarray(jax.random.uniform(k_strat, (R, S)))
    ui = np.asarray(jax.random.uniform(k_imp, (R, NI)))
    model = NeRFMLP(10, 4, True, hidden_dim=HIDDEN, num_layers=N_LAYERS)
    model.load_state_dict(nerf_mlp_from_jax(params))
    got = render_rays(model, _t(ro), _t(rd),
                      RenderSettings(n_samples=S, n_importance=NI, perturb=perturb,
                                     white_bkgd=white_bkgd), _t(u), _t(ui))
    assert got.weights.shape == (R, S + NI)
    _assert_outputs_close(got, want)


def test_render_rays_fine_pass_stops_the_gradient_of_the_coarse_weights():
    """The importance samples come from the coarse weights under
    stop-gradient; the fine pass re-renders with the same model, so the
    gradient of a fine-pass loss equals that of a single pass over the
    merged depths."""
    _, params = _jax_params()
    ro, rd, _ = _rays(8)
    model = NeRFMLP(10, 4, True, hidden_dim=HIDDEN, num_layers=N_LAYERS)
    model.load_state_dict(nerf_mlp_from_jax(params))
    settings = RenderSettings(n_samples=S, n_importance=NI)
    out = render_rays(model, _t(ro), _t(rd), settings)
    out.rgb.sum().backward()
    g_hier = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    with torch.no_grad():
        coarse = render_rays(model, _t(ro), _t(rd), RenderSettings(n_samples=S))
    _, z_coarse = ts.sample_along_rays(_t(ro), _t(rd), 2.0, 6.0, S)
    pts, z = ts.hierarchical_sample(_t(ro), _t(rd), z_coarse, coarse.weights, NI)
    model.zero_grad()
    from nerf_fewshot_tpu_torch.ops.composite import volume_render

    dirs = _t(rd)[:, None, :].expand(R, S + NI, 3).reshape(-1, 3)
    rgb, sigma = model(pts.reshape(-1, 3), dirs)
    volume_render(rgb.reshape(R, S + NI, 3), sigma.reshape(R, S + NI), z,
                  _t(rd)).rgb.sum().backward()
    g_single = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    torch.testing.assert_close(g_hier, g_single, rtol=0, atol=0)


CASES = {
    "inline_pe": dict(inline_pe=True),
    "inline_pe_perturbed_white": dict(inline_pe=True, perturb=True, white_bkgd=True),
    "x_input": dict(inline_pe=False),
    "x_input_perturbed_masked": dict(inline_pe=False, perturb=True, ragged=5),
}


def _grads_close(got, want_tree, vector_rtol=1e-4, per_leaf=True):
    want = nerf_mlp_from_jax(want_tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if per_leaf:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=1e-6 * max(1.0, float(want[k].abs().max())),
                                       err_msg=k)
    g = torch.cat([got[k].reshape(-1).double() for k in want])
    w = torch.cat([want[k].reshape(-1).double() for k in want])
    assert w.norm() > 1e-6
    assert ((g - w).norm() / w.norm()).item() < vector_rtol


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchical_train_objective_matches_jax_kernel(case):
    """Both ``inline_pe`` modes: the coarse pass (kernel 2, or kernel 4 on
    the encoded x), the importance samples, then the objective over the
    merged ``S + NI`` samples, against the JAX function in interpret mode
    with the same key (split into the stratified and importance keys)."""
    kw = dict(CASES[case])
    inline_pe, perturb = kw.pop("inline_pe"), kw.pop("perturb", False)
    white, ragged = kw.pop("white_bkgd", False), kw.pop("ragged", 0)
    _, params = _jax_params(seed=1)
    ro, rd, rng = _rays(9)
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (np.arange(R) < R - ragged).astype(np.float32)
    key = jax.random.key(9)
    want_loss, want_grads = jax_loss_grad(
        params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), jnp.asarray(mask),
        JaxRenderSettings(n_samples=S, n_importance=NI, perturb=perturb, white_bkgd=white),
        10, 4, N_LAYERS, HIDDEN, key=key, interpret=True, inline_pe=inline_pe)
    k_strat, k_imp = jax.random.split(key)
    u = _t(jax.random.uniform(k_strat, (R, S)))
    ui = _t(jax.random.uniform(k_imp, (R, NI)))
    got_loss, got_grads = tt.fused_train_loss_grad(
        nerf_mlp_from_jax(params), _t(ro), _t(rd), _t(tgt), _t(mask),
        RenderSettings(n_samples=S, n_importance=NI, perturb=perturb, white_bkgd=white),
        10, 4, N_LAYERS, HIDDEN, uniforms=u, importance_uniforms=ui, inline_pe=inline_pe)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    if perturb:  # see the module docstring: vector only, rel 5e-3
        _grads_close(got_grads, want_grads, vector_rtol=5e-3, per_leaf=False)
    else:
        _grads_close(got_grads, want_grads)


def test_hierarchical_objective_runs_the_coarse_pass_without_gradient():
    """The coarse pass is forward-only: the objective's gradient equals
    that of the single-pass objective over the merged depths."""
    _, params = _jax_params(seed=2)
    state = nerf_mlp_from_jax(params)
    ro, rd, rng = _rays(10)
    tgt = _t(rng.uniform(0, 1, (R, 3)))
    settings = RenderSettings(n_samples=S, n_importance=NI)
    loss, grads = tt.fused_train_loss_grad(state, _t(ro), _t(rd), tgt, torch.ones(R), settings,
                                           10, 4, N_LAYERS, HIDDEN)
    args, opts = tt.train_objective_inputs(state, _t(ro), _t(rd), tgt, torch.ones(R), settings,
                                           10, 4, N_LAYERS, HIDDEN)
    assert args[2].shape == (R, S + NI)  # the objective's depths: merged and sorted
    assert bool(torch.all(args[2][:, 1:] >= args[2][:, :-1]))
    loss2, _ = tt.fused_train_objective(*args, **opts)
    assert float(loss) == float(loss2)


RES = 16


def _trainer_config(mod, **rendering):
    return mod.config_from_dict({
        "experiment": {"name": "port-hier"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 128, "n_importance": 8, **rendering},
        "output": {"save_dir": "unused", "val_freq": 1, "save_freq": 1},
        "seed": 0,
    })


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_hierarchical_trainer_matches_jax_trainer(monkeypatch, backend):
    """``experiments/hierarchical.yaml``'s path at a tiny size: two epochs
    (one per phase) of the JAX trainer through its interpret-mode kernels
    against the port through the kernels' plain versions (``auto``) or the
    plain pipeline (``xla``), same init, jitter off; then the hierarchical
    eval render (both passes) of both."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 1, img_size=RES, gt_samples=32, split="test")
    jtr = jax_trainer_mod.Trainer(_trainer_config(jcfg), train, test)
    ptr = Trainer(_trainer_config(tcfg, backend=backend), _port_data(train), _port_data(test),
                  device="cpu")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    for epoch in (0, 1):
        np.testing.assert_allclose(ptr.train_epoch(epoch), jtr.train_epoch(epoch), rtol=1e-4)
    assert ptr.kernel_path == ("kernel" if backend == "auto" else "plain")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    want = jtr.render_views([test.poses[0]])
    got = ptr.render_views([test.poses[0]])
    for g, w, name in zip(got, want, ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4 if name == "depth" else 2e-5,
                                   err_msg=name)


def test_hierarchical_trainer_draws_importance_uniforms():
    """With jitter on, each step draws its stratified and then its
    importance uniforms from the trainer's generator; the CPU path launches
    no kernel."""
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    ptr = Trainer(_trainer_config(tcfg), _port_data(train), device="cpu")
    before = (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches)
    draws = []
    orig = torch.rand

    def rand(shape, *a, **k):
        draws.append(tuple(shape))
        return orig(shape, *a, **k)

    torch.rand = rand
    try:
        loss = ptr.train_epoch(0)
    finally:
        torch.rand = orig
    assert np.isfinite(loss)
    assert draws == [(48, 8), (48, 8)] * 4  # 2 views x 2 steps: stratified, importance
    assert (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches) == before
