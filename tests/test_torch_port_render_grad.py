"""The differentiable fused render of the port against the JAX package:
``fused_render`` (kernel 4 forward, kernel 3 backward; on the CPU their
plain versions ``fused_render_reference`` and ``fused_render_bwd_reference``)
against the JAX ``fused_render`` with its custom VJP, running its Pallas
kernels in interpret mode, and ``fused_render_rays(forward_only=False)``,
plain and hierarchical, against the JAX function, on the same numpy-seeded
inputs and transplanted weights.

Tolerances, with their reasons:
- forward outputs: 1e-5 abs on rgb / acc / weights and 2e-5 on depth
  (z up to 6); fp32 sums in another order (the JAX kernel's transmittance
  is a triangular matmul, the port's a ``cumsum``);
- ``dx`` and the parameter gradients: as one vector within rel 1e-4, and
  each leaf within rtol 1e-3 / atol 1e-6 of its own scale (single elements
  near zero differ by rounding);
- the analytic backward against ``torch.autograd`` of the plain forward:
  rel 1e-5 per output (measured ~3e-7);
- ``fused_render_rays``: the gradient vector within rel 1e-4 (measured
  9e-6 to 4.8e-5) and no single element compared, the loss within rtol
  1e-4 (measured up to 3.7e-5). Each framework encodes its own sample
  points there, and XLA fuses ``o + d*z`` into one rounding: points differ
  by an ulp, which the top PE band (2^9 rad per unit) turns into the
  2e-4 rad of ``test_torch_port_ops.py``'s encoding tolerance, so single
  first-layer gradient elements differ by up to ~4e-5 while the vector
  agrees. With perturbed hierarchical samples the importance samples also
  follow the two routes' coarse weights, which differ by ~1e-6
  (``test_torch_port_hierarchical.py``).
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.render import fused as jfused
from nerf_fewshot_tpu.render import kernels as jk
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

HIDDEN, N_LAYERS = 128, 3
R, S = 16, 16
CSRC = os.path.join(os.path.dirname(tk.__file__), "..", "csrc")


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _params(feat_dim=0, seed=0, sigma_bias=0.1):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, dino_dim=feat_dim,
                       hidden_dim=HIDDEN, num_layers=N_LAYERS, sigma_bias_init=sigma_bias)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, feat_dim))] if feat_dim else [])
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(seed), *args)["params"])


def _inputs(seed, feat_dim=0):
    """Encoded inputs of R rays x S jittered samples in [2, 6]: x (R*S, D),
    z, dnorm, and standard-normal cotangents of the four outputs."""
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    feats = rng.standard_normal((R * S, feat_dim)).astype(np.float32) if feat_dim else None
    x = np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, True,
                                        None if feats is None else jnp.asarray(feats)))
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    cot = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    return x, z, dnorm, cot


def _grads_close(got, want, vector_rtol=1e-4, per_leaf=True):
    """``got``/``want``: dicts of same-shaped tensors."""
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


def _outputs_close(got, want):
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 if name == "depth" else 1e-5, err_msg=name)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_fused_render_forward_matches_jax(white_bkgd):
    params = _params()
    x, z, dnorm, _ = _inputs(0)
    packed = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=x.shape[1])
    want = jk.fused_render(jnp.asarray(x), jnp.asarray(z), jnp.asarray(dnorm), *packed,
                           white_bkgd, 8, True)
    packed_t = tuple(_t(p) for p in packed)
    got = tk.fused_render(_t(x), _t(z), _t(dnorm), packed_t, white_bkgd=white_bkgd)
    _outputs_close(got, want)
    # on CPU tensors kernel 4's wrapper is its plain version, bit for bit
    for a, b in zip(tk.fused_render_fwd(_t(x), _t(z), _t(dnorm), packed_t, white_bkgd),
                    tk.fused_render_reference(_t(x), _t(z), _t(dnorm), packed_t, white_bkgd)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("sigma_bias", [0.1, 2.0])
def test_fused_render_vjp_matches_jax(white_bkgd, sigma_bias):
    """``dx`` and every ``NeRFMLP`` parameter's gradient through the
    differentiable ``pack_params`` and ``fused_render``, with random
    cotangents on all four outputs, against ``jax.vjp`` through JAX
    ``pack_params`` + ``fused_render(interpret=True)``."""
    params = _params(sigma_bias=sigma_bias)
    x, z, dnorm, cot = _inputs(1)
    D = x.shape[1]

    def jax_fn(p, xx):
        return jk.fused_render(xx, jnp.asarray(z), jnp.asarray(dnorm),
                               *jk.pack_params(p, N_LAYERS, HIDDEN, d_pad=D), white_bkgd, 8, True)

    _, vjp = jax.vjp(jax_fn, params, jnp.asarray(x))
    want_p, want_dx = vjp(tuple(jnp.asarray(c) for c in cot))

    state = {k: v.requires_grad_(True) for k, v in nerf_mlp_from_jax(params).items()}
    xt = _t(x).requires_grad_(True)
    outs = tk.fused_render(xt, _t(z), _t(dnorm), tk.pack_params(state, N_LAYERS, HIDDEN, d_pad=D),
                           white_bkgd=white_bkgd)
    torch.autograd.backward(outs, [_t(c) for c in cot])
    got = {k: v.grad for k, v in state.items()}
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, want_p))
    _grads_close({**got, "dx": xt.grad}, {**want, "dx": _t(want_dx)})


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("need_dx", [True, False])
def test_bwd_reference_matches_autograd_of_the_forward(white_bkgd, need_dx):
    """Kernel 3's plain version, written out analytically, against
    ``torch.autograd`` of kernel 4's plain version."""
    params = _params(seed=2)
    x, z, dnorm, cot = _inputs(2)
    packed = tuple(_t(p) for p in jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=x.shape[1]))
    leaves = [_t(x).requires_grad_(True)] + [p.clone().requires_grad_(True) for p in packed]
    outs = tk.fused_render_reference(leaves[0], _t(z), _t(dnorm), tuple(leaves[1:]), white_bkgd)
    want = torch.autograd.grad(outs, leaves, [_t(c) for c in cot])
    dx, dpacked = tk.fused_render_bwd_reference(_t(x), _t(z), _t(dnorm), packed,
                                                *map(_t, cot), white_bkgd, need_dx=need_dx)
    assert (dx is None) == (not need_dx)
    got = ([dx] if need_dx else []) + list(dpacked)
    for g, w in zip(got, want if need_dx else want[1:]):
        assert g.shape == w.shape
        assert ((g - w).norm() / w.norm()).item() < 1e-5
    # on CPU tensors kernel 3's wrapper is its plain version, bit for bit
    via = tk.fused_render_bwd(_t(x), _t(z), _t(dnorm), packed, *map(_t, cot), white_bkgd,
                              need_dx=need_dx)
    for a, b in zip(([via[0]] if need_dx else []) + list(via[1]), got):
        assert torch.equal(a, b)


def test_fused_render_gives_no_gradient_to_z_and_dnorm_and_dx_only_when_asked():
    """As the JAX rule: zero cotangents for ``z`` and ``dnorm``; ``dx`` is
    computed only when ``x`` requires a gradient."""
    params = _params()
    x, z, dnorm, cot = _inputs(3)
    packed = [_t(p).requires_grad_(True)
              for p in jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=x.shape[1])]
    zt, dt = _t(z).requires_grad_(True), _t(dnorm).requires_grad_(True)
    outs = tk.fused_render(_t(x), zt, dt, tuple(packed))
    assert all(o.requires_grad for o in outs)
    torch.autograd.backward(outs, [_t(c) for c in cot])
    assert zt.grad is None and dt.grad is None
    assert all(p.grad is not None and p.grad.norm() > 0 for p in packed[:1])


def _rays(seed, n=R):
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    return ro, rd, rng


def _loss_weights(rng, n_samples):
    """Random weights of a scalar loss over all four outputs."""
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((R, 3), (R,), (R,), (R, n_samples))]


@pytest.mark.parametrize("n_importance", [0, 8])
@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_fused_render_rays_differentiable_matches_jax(n_importance, perturb, white_bkgd):
    """``fused_render_rays(forward_only=False)`` with stratified and importance
    uniforms (the JAX function's, from its split key) against the JAX
    function in interpret mode: outputs, and the gradient of a loss on all
    four outputs with respect to every parameter."""
    params = _params(seed=4)
    ro, rd, rng = _rays(5)
    lw = _loss_weights(rng, S + n_importance)
    key = jax.random.key(5)
    js_settings = JaxRenderSettings(n_samples=S, n_importance=n_importance, perturb=perturb,
                                    white_bkgd=white_bkgd)

    def jax_loss(p):
        out = jfused.fused_render_rays(p, jnp.asarray(ro), jnp.asarray(rd), js_settings, 10, 4,
                                       N_LAYERS, HIDDEN, key=key, tile_rays=8, interpret=True)
        loss = sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(out, lw))
        return loss, out

    (want_loss, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    k_strat, k_imp = jax.random.split(key)
    u = _t(jax.random.uniform(k_strat, (R, S)))
    ui = _t(jax.random.uniform(k_imp, (R, max(n_importance, 1))))
    state = {k: v.requires_grad_(True) for k, v in nerf_mlp_from_jax(params).items()}
    out = fused_render_rays(state, _t(ro), _t(rd),
                            RenderSettings(n_samples=S, n_importance=n_importance,
                                           perturb=perturb, white_bkgd=white_bkgd),
                            10, 4, N_LAYERS, HIDDEN, device="cpu", uniforms=u,
                            importance_uniforms=ui)
    assert all(o.requires_grad for o in out)
    loss = sum(torch.sum(o * _t(w)) for o, w in zip(out, lw))
    loss.backward()
    _outputs_close(out, want_out)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    _grads_close({k: v.grad for k, v in state.items()}, want, per_leaf=False)


def test_fused_render_rays_point_features_get_their_gradient():
    """``point_features_fn``'s output enters the encoded x, so its gradient
    is kernel 3's ``dx`` on the feature columns: against JAX's."""
    feat_dim = 32
    params = _params(feat_dim=feat_dim, seed=6)
    ro, rd, rng = _rays(6)
    feats = rng.standard_normal((R * S, feat_dim)).astype(np.float32)
    lw = _loss_weights(rng, S)
    settings = dict(n_samples=S, white_bkgd=True)

    def jax_loss(p, f):
        out = jfused.fused_render_rays(p, jnp.asarray(ro), jnp.asarray(rd),
                                       JaxRenderSettings(**settings), 10, 4, N_LAYERS, HIDDEN,
                                       point_features_fn=lambda pts: f, tile_rays=8,
                                       interpret=True)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(out, lw))

    want_p, want_f = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(feats))
    state = {k: v.requires_grad_(True) for k, v in nerf_mlp_from_jax(params).items()}
    ft = _t(feats).requires_grad_(True)
    out = fused_render_rays(state, _t(ro), _t(rd), RenderSettings(**settings), 10, 4, N_LAYERS,
                            HIDDEN, device="cpu", point_features_fn=lambda pts: ft)
    sum(torch.sum(o * _t(w)) for o, w in zip(out, lw)).backward()
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, want_p))
    _grads_close({**{k: v.grad for k, v in state.items()}, "feats": ft.grad},
                 {**want, "feats": _t(want_f)}, per_leaf=False)


def test_forward_only_renders_carry_no_graph():
    state = {k: v.requires_grad_(True) for k, v in nerf_mlp_from_jax(_params()).items()}
    ro, rd, _ = _rays(7)
    for n_importance in (0, 8):
        out = fused_render_rays(state, _t(ro), _t(rd),
                                RenderSettings(n_samples=S, n_importance=n_importance),
                                10, 4, N_LAYERS, HIDDEN, forward_only=True, device="cpu")
        assert not any(o.requires_grad for o in out)
        assert out.weights.shape == (R, S + n_importance)


def test_render_kernel_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU never reaches a plain version; the
    CPU runs the plain versions and launches nothing."""
    x, z, dnorm, cot = _inputs(8)
    packed = tuple(_t(p) for p in jk.pack_params(_params(), N_LAYERS, HIDDEN, d_pad=x.shape[1]))
    args = (_t(x), _t(z), _t(dnorm), packed)
    meta = tuple(tuple(p.to("meta") for p in a) if isinstance(a, tuple) else a.to("meta")
                 for a in args)
    before = (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.fused_render_fwd(*meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.fused_render_bwd(*meta, *(_t(c).to("meta") for c in cot))
    tk.fused_render_fwd(*args)
    tk.fused_render_bwd(*args, *map(_t, cot))
    assert (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches) == before
    with pytest.raises(ValueError, match="compute_dtype"):
        tk.fused_render(*args, compute_dtype="float16")
    # bfloat16 runs the plain versions at that route (tests/test_torch_port_precision.py)
    bf16 = tk.fused_render(*args, compute_dtype="bfloat16")
    assert all(torch.isfinite(t).all() for t in bf16)
    assert (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches) == before


@pytest.mark.parametrize("source,name,argtypes", [
    ("fwd_pe.cu", "nerf_fwd_pe", tk.FWD_PE_ARGTYPES),
    ("fwd_pe.cu", "nerf_fwd_x", tk.FWD_X_ARGTYPES),
    ("train_pe.cu", "nerf_train_objective", tt.TRAIN_ARGTYPES),
    ("train_pe.cu", "nerf_render_bwd", tk.RENDER_BWD_ARGTYPES),
])
def test_ctypes_signatures_match_the_cuda_launchers(source, name, argtypes):
    """argtypes of each ctypes binding follow its C parameters: c_void_p for
    every pointer and the stream, c_float for a float, c_int for an int."""
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", f.read())
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float ")
            else ctypes.c_int for p in params]
    assert list(argtypes) == want
