"""The inline-PE forward render: the port's host glue and the plain version
of its CUDA kernel against the JAX package's Pallas kernel, run in
interpret mode on the CPU, on the same numpy-seeded inputs.

Tolerance of the render outputs: rtol 2e-4 / atol 2e-5 (depth 2e-4),
the bound the JAX package's own kernel-vs-XLA test uses. The PE phases are
bit-identical (products by powers of two are exact); what differs is the
order of the fp32 sums in the trunk matmuls and in the transmittance
prefix sum (a triangular matmul in JAX, a cumsum here).
"""

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
from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

RNG = np.random.default_rng(5)
HIDDEN, N_LAYERS = 128, 3
TOL = dict(rgb=(2e-4, 2e-5), depth=(2e-4, 2e-4), acc=(2e-4, 2e-5), weights=(2e-4, 2e-5))


def _params(use_viewdirs=True, feat_dim=0, seed=0):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=use_viewdirs,
                       dino_dim=feat_dim, hidden_dim=HIDDEN, num_layers=N_LAYERS,
                       sigma_bias_init=0.1)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))]
    if feat_dim:
        args.append(jnp.zeros((1, feat_dim)))
    params = model.init(jax.random.key(seed), *args)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _assert_outputs_close(got, want):
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("pos_freq,dir_freq,use_viewdirs,feat_dim", [
    (10, 4, True, 0), (10, 4, False, 0), (8, 2, True, 64), (6, 3, False, 32),
])
def test_pe_layout_matches_jax(pos_freq, dir_freq, use_viewdirs, feat_dim):
    want = jk.pe_layout(pos_freq, dir_freq, use_viewdirs, feat_dim)
    got = tk.pe_layout(pos_freq, dir_freq, use_viewdirs, feat_dim)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


def test_pe_layout_baseline_width():
    """Baseline widths: 6 raw + 84 phase columns = x_dim 90."""
    perm, e2, c, x_dim = tk.pe_layout(10, 4, True, 0)
    assert (x_dim, e2.shape, c.shape) == (90, (6, 84), (1, 84))
    assert sorted(perm) == list(range(90))


@pytest.mark.parametrize("feat_dim", [0, 64])
def test_pack_params_matches_jax(feat_dim):
    params = _params(feat_dim=feat_dim)
    perm, _, _, x_dim = jk.pe_layout(10, 4, True, feat_dim)
    d_pad = -(-x_dim // 128) * 128
    want = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm)
    state = nerf_mlp_from_jax(params) if not feat_dim else _state_with_feats(params)
    got = tk.pack_params(state, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _state_with_feats(params):
    """The port's NeRFMLP has no feature input yet; the kernel glue still
    takes a feature-extended first layer, built here the same way."""
    state = {}
    for name, layer in params.items():
        key = name.replace("trunk_", "trunk.")
        state[f"{key}.weight"] = _t(layer["kernel"].T)
        state[f"{key}.bias"] = _t(layer["bias"])
    return state


def test_raw_block_matches_jax():
    pts = RNG.standard_normal((4, 5, 3)).astype(np.float32)
    rd = RNG.standard_normal((4, 3)).astype(np.float32)
    for use_viewdirs in (True, False):
        want = jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), use_viewdirs)
        got = tk._raw_block(_t(pts), _t(rd), use_viewdirs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kernel_inputs(R, S, feat_dim):
    params = _params(feat_dim=feat_dim)
    perm, e2, c, x_dim = jk.pe_layout(10, 4, True, feat_dim)
    d_pad = -(-x_dim // 128) * 128
    packed_j = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm)
    pts = RNG.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    rd = RNG.standard_normal((R, 3)).astype(np.float32)
    raw = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    z = np.sort(RNG.uniform(2.0, 6.0, (R, S)).astype(np.float32), axis=-1)
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    feats = (RNG.standard_normal((R * S, feat_dim)).astype(np.float32) if feat_dim
             else np.zeros((R * S, 8), np.float32))
    return packed_j, raw, feats, z, dnorm, e2, c


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("feat_dim", [0, 64])
def test_fwd_pe_reference_matches_pallas_interpret(white_bkgd, feat_dim):
    R, S = 16, 16
    packed_j, raw, feats, z, dnorm, e2, c = _kernel_inputs(R, S, feat_dim)
    use_feats = feat_dim > 0
    want = jk.fused_render_fwd_pe(
        jnp.asarray(raw), jnp.asarray(feats), jnp.asarray(z), jnp.asarray(dnorm),
        jnp.asarray(e2), jnp.asarray(c), packed_j, white_bkgd, tile_rays=8,
        interpret=True, use_feats=use_feats,
    )
    packed_t = tuple(_t(p) for p in packed_j)
    args = (_t(raw), _t(feats) if use_feats else None, _t(z), _t(dnorm), _t(e2), _t(c), packed_t)
    got = tk.fused_render_fwd_pe_reference(*args, white_bkgd=white_bkgd, use_feats=use_feats)
    _assert_outputs_close(got, want)
    # on CPU tensors the wrapper is the plain version, bit for bit
    via_wrapper = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=use_feats)
    for a, b in zip(via_wrapper, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fwd_pe_phases_are_exact():
    """c + raw.e2 as broadcast multiply-adds equals the float64 phase
    rounded once to fp32: the products by powers of two are exact."""
    _, e2, c, _ = tk.pe_layout(10, 4, True, 0)
    raw = RNG.uniform(-4, 4, (50, 6)).astype(np.float32)
    got = tk._phases_exact(_t(raw), _t(e2), _t(c)).numpy()
    want = (c.astype(np.float64) + raw.astype(np.float64) @ e2.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_fwd_pe_takes_every_route_and_refuses_unknown_dtypes():
    """``bfloat16`` runs its plain version (its products' operands rounded
    to bf16, apart from the fp32 result), ``highest`` the exact fp32
    function (bit-equal to ``float32``'s plain version on the CPU); an
    unknown dtype raises. tests/test_torch_port_precision.py holds the
    routes against the JAX kernels."""
    _, raw, _, z, dnorm, e2, c = _kernel_inputs(2, 4, 0)
    packed = tuple(_t(p) for p in _kernel_inputs(2, 4, 0)[0])
    args = (_t(raw), None, _t(z), _t(dnorm), _t(e2), _t(c), packed)
    with pytest.raises(ValueError, match="compute_dtype"):
        tk.fused_render_fwd_pe(*args, compute_dtype="float16")
    f32 = tk.fused_render_fwd_pe(*args)
    for a, b in zip(tk.fused_render_fwd_pe(*args, compute_dtype="highest"), f32):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    bf16 = tk.fused_render_fwd_pe(*args, compute_dtype="bfloat16")
    for a, b in zip(bf16, tk.fused_render_fwd_pe_reference(*args, compute_dtype="bfloat16")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(torch.isfinite(t).all() for t in bf16)
    assert (bf16[0] - f32[0]).abs().max() > 1e-5


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_fused_render_rays_forward_only_matches_jax(white_bkgd):
    R, S = 24, 16
    params = _params()
    ro = RNG.standard_normal((R, 3)).astype(np.float32) * 0.3 + np.array([0, 0, 4], np.float32)
    rd = RNG.standard_normal((R, 3)).astype(np.float32) * 0.2 + np.array([0, 0, -1], np.float32)
    want = jfused.fused_render_rays(
        params, jnp.asarray(ro), jnp.asarray(rd),
        JaxRenderSettings(n_samples=S, white_bkgd=white_bkgd),
        pos_freq=10, dir_freq=4, num_layers=N_LAYERS, hidden_dim=HIDDEN,
        tile_rays=8, interpret=True, forward_only=True,
    )
    got = fused_render_rays(
        nerf_mlp_from_jax(params), _t(ro), _t(rd),
        RenderSettings(n_samples=S, white_bkgd=white_bkgd),
        pos_freq=10, dir_freq=4, num_layers=N_LAYERS, hidden_dim=HIDDEN,
        forward_only=True, device="cpu",
    )
    _assert_outputs_close(got, want)


def test_fused_render_rays_refuses_unported_modes():
    """Sigma noise (which the JAX fused backend refuses too) raises in both
    modes, and so does an unknown ``compute_dtype``; ``bfloat16`` renders
    in both, hierarchical too, apart from ``float32``. The differentiable
    and hierarchical modes are ported (tests/test_torch_port_render_grad.py,
    tests/test_torch_port_hierarchical.py)."""
    state = nerf_mlp_from_jax(_params())
    ro = torch.tensor([[0.0, 0.0, 4.0]]).expand(8, 3).contiguous()
    rd = torch.tensor((RNG.standard_normal((8, 3)) * 0.3 + [0, 0, -1]).astype(np.float32))
    kw = dict(pos_freq=10, dir_freq=4, num_layers=N_LAYERS, hidden_dim=HIDDEN, device="cpu")
    hier = RenderSettings(n_samples=8, n_importance=8)
    for forward_only in (True, False):
        with pytest.raises(ValueError, match="noise"):
            fused_render_rays(state, ro, rd, RenderSettings(n_samples=8, noise_std=1.0),
                              forward_only=forward_only, **kw)
        with pytest.raises(ValueError, match="compute_dtype"):
            fused_render_rays(state, ro, rd, hier, forward_only=forward_only,
                              compute_dtype="float16", **kw)
        outs = {cd: fused_render_rays(state, ro, rd, hier, forward_only=forward_only,
                                      compute_dtype=cd, **kw)
                for cd in ("float32", "bfloat16")}
        assert torch.isfinite(outs["bfloat16"].rgb).all()
        assert (outs["bfloat16"].rgb - outs["float32"].rgb).abs().max() > 1e-6


def test_ctypes_signature_matches_the_cuda_launcher():
    """argtypes of the ctypes binding follow nerf_fwd_pe's C parameters:
    c_void_p for every pointer and the stream, c_int for every int."""
    import ctypes
    import os
    import re

    src = os.path.join(os.path.dirname(tk.__file__), "..", "csrc", "fwd_pe.cu")
    with open(src) as f:
        m = re.search(r'extern "C" int nerf_fwd_pe\(([^)]*)\)', f.read())
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert tk.FWD_PE_ARGTYPES == want
