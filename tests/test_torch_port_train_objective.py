"""The training objective of the port against the JAX package: ``nerf_loss``,
``encode_points`` and ``fused_train_loss_grad`` (whose CPU route is the plain
version of the CUDA training kernel) against the JAX
``fused_train_loss_grad`` running its Pallas kernel in interpret mode, on the
same numpy-seeded rays and transplanted weights.

Tolerances, with their reasons:
- losses: rtol 1e-5, fp32 sums in another order;
- gradients: each leaf within rtol 1e-3 / atol 1e-6 of its own scale, and
  the whole gradient vector within rel 1e-4. The two sides compute the same
  function in fp32 by different routes (the JAX kernel: a triangular matmul
  for the transmittance and the analytic backward; the port's plain version:
  ``cumsum`` and autograd), so single elements near zero differ by rounding
  while the vector agrees tightly.
- with per-point features, hidden pre-activations of the seeded data come
  within 1e-6 of zero, and their ReLU gates flip between the two fp32
  routes: there the gradient vector is held to rel 5e-3 and no single
  element is compared (the JAX package's own feature test compares the
  vector only, for the same reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.render import fused as jfused
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu.render.train_kernel import fused_train_loss_grad as jax_loss_grad
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.training.losses import nerf_loss as jax_nerf_loss
from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import fused as tfused
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.losses import nerf_loss

HIDDEN, N_LAYERS = 128, 3


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_params(feat_dim=0, use_viewdirs=True, sigma_bias=0.1, seed=0):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=use_viewdirs, dino_dim=feat_dim,
                       hidden_dim=HIDDEN, num_layers=N_LAYERS, sigma_bias_init=sigma_bias)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, feat_dim))] if feat_dim else [])
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(seed), *args)["params"])


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("depth_weight,reg_weight", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.01),
                                                     (0.2, 0.05)])
def test_nerf_loss_matches_jax(with_mask, depth_weight, reg_weight):
    rng = np.random.default_rng(3)
    R, S = 24, 10
    pred, tgt = rng.uniform(0, 1, (R, 3)), rng.uniform(0, 1, (R, 3))
    pd, td = rng.uniform(2, 6, R), rng.uniform(2, 6, R)
    w = rng.uniform(0, 1, (R, S))
    mask = (rng.uniform(0, 1, R) > 0.3).astype(np.float32) if with_mask else None
    kw = dict(rgb_weight=1.0, depth_weight=depth_weight, reg_weight=reg_weight)
    want = jax_nerf_loss(jnp.asarray(pred, jnp.float32), jnp.asarray(tgt, jnp.float32),
                         jcfg.LossConfig(**kw), pred_depth=jnp.asarray(pd, jnp.float32),
                         target_depth=jnp.asarray(td, jnp.float32),
                         weights=jnp.asarray(w, jnp.float32),
                         mask=None if mask is None else jnp.asarray(mask))
    got = nerf_loss(_t(pred), _t(tgt), tcfg.LossConfig(**kw), pred_depth=_t(pd),
                    target_depth=_t(td), weights=_t(w),
                    mask=None if mask is None else _t(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("use_viewdirs,feat_dim", [(True, 0), (False, 0), (True, 64)])
def test_encode_points_matches_jax(use_viewdirs, feat_dim):
    """Same column order and padding; values to 1e-6 (sin/cos of the same
    fp32 phases in two libraries)."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    rd = rng.standard_normal((5, 3)).astype(np.float32)
    feats = rng.standard_normal((35, feat_dim)).astype(np.float32) if feat_dim else None
    want = np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, use_viewdirs,
                                           None if feats is None else jnp.asarray(feats)))
    got = tfused.encode_points(_t(pts), _t(rd), 10, 4, use_viewdirs,
                               None if feats is None else _t(feats)).numpy()
    assert got.shape == want.shape and got.shape[1] % 128 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


CASES = {
    "plain": {},
    "white_bkgd": dict(white_bkgd=True),
    "masked_tail": dict(ragged=9),
    "white_masked_reg": dict(white_bkgd=True, ragged=9, reg_weight=0.01),
    "depth": dict(depth_weight=0.1),
    "full_loss_masked": dict(ragged=9, reg_weight=0.01, depth_weight=0.1),
    "feats": dict(feat_dim=64),
    "x_input": dict(inline_pe=False),
    "x_input_full_loss_feats": dict(inline_pe=False, ragged=9, reg_weight=0.01, depth_weight=0.1,
                                    feat_dim=32),
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
def test_train_objective_matches_jax_kernel(case):
    kw = dict(CASES[case])
    white, ragged = kw.pop("white_bkgd", False), kw.pop("ragged", 0)
    feat_dim, inline_pe = kw.pop("feat_dim", 0), kw.pop("inline_pe", True)
    reg, depth = kw.pop("reg_weight", 0.0), kw.pop("depth_weight", 0.0)
    rng = np.random.default_rng(6)
    R, S = 48, 16
    params = _jax_params(feat_dim)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (np.arange(R) < R - ragged).astype(np.float32)
    tgt_d = rng.uniform(2.5, 5.5, R).astype(np.float32)
    # per-point features from the seed, bit-identical on both sides
    feats = rng.standard_normal((R * S, max(feat_dim, 1))).astype(np.float32)
    jpf = (lambda p: jnp.asarray(feats)) if feat_dim else None
    tpf = (lambda p: _t(feats)) if feat_dim else None

    want_loss, want_grads = jax_loss_grad(
        params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), jnp.asarray(mask),
        JaxRenderSettings(near=2.0, far=6.0, n_samples=S, white_bkgd=white, perturb=False),
        10, 4, N_LAYERS, HIDDEN, interpret=True, inline_pe=inline_pe, reg_weight=reg,
        depth_weight=depth, target_depth=jnp.asarray(tgt_d) if depth else None,
        point_features_fn=jpf)
    got_loss, got_grads = tt.fused_train_loss_grad(
        nerf_mlp_from_jax(params), _t(ro), _t(rd), _t(tgt), _t(mask),
        RenderSettings(near=2.0, far=6.0, n_samples=S, white_bkgd=white, perturb=False),
        10, 4, N_LAYERS, HIDDEN, inline_pe=inline_pe, reg_weight=reg, depth_weight=depth,
        target_depth=_t(tgt_d) if depth else None, point_features_fn=tpf)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    if feat_dim:
        _grads_close(got_grads, want_grads, vector_rtol=5e-3, per_leaf=False)
    else:
        _grads_close(got_grads, want_grads)


def test_denom_rays_and_depth_without_targets_match_jax():
    """``denom_rays`` sets the normalizer (a DP shard passes the global
    count); ``depth_weight`` without ``target_depth`` is dropped, as in JAX."""
    rng = np.random.default_rng(8)
    R, S = 32, 12
    params = _jax_params()
    ro, rd = rng.standard_normal((R, 3)), rng.standard_normal((R, 3))
    tgt, mask = rng.uniform(0, 1, (R, 3)), (np.arange(R) < 20).astype(np.float32)
    args = [np.asarray(a, np.float32) for a in (ro, rd, tgt, mask)]
    want_loss, want_grads = jax_loss_grad(
        params, *map(jnp.asarray, args),
        JaxRenderSettings(n_samples=S, perturb=False), 10, 4, N_LAYERS, HIDDEN,
        interpret=True, denom_rays=jnp.asarray(57.0), depth_weight=0.3)
    got_loss, got_grads = tt.fused_train_loss_grad(
        nerf_mlp_from_jax(params), *map(_t, args), RenderSettings(n_samples=S),
        10, 4, N_LAYERS, HIDDEN, denom_rays=57.0, depth_weight=0.3)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    _grads_close(got_grads, want_grads)


def test_train_objective_refuses_what_is_not_ported():
    state = {k: v for k, v in nerf_mlp_from_jax(_jax_params()).items()}
    ro, rd, tgt = torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="noise"):
        tt.fused_train_loss_grad(state, ro, rd, tgt, torch.ones(4),
                                 RenderSettings(n_samples=8, noise_std=1.0), 10, 4, 3, 128)
    with pytest.raises(ValueError, match="compute_dtype"):
        tt.fused_train_loss_grad(state, ro, rd, tgt, torch.ones(4), RenderSettings(n_samples=8),
                                 10, 4, 3, 128, compute_dtype="float16")
    # bfloat16 is ported (tests/test_torch_port_precision.py): finite, and
    # apart from float32
    ro = torch.tensor([[0.0, 0.0, 4.0]]).expand(4, 3).contiguous()
    rd = torch.tensor([[0.1, 0.2, -1.0], [0.0, -0.1, -1.0], [-0.2, 0.1, -1.0], [0.1, 0.0, -1.0]])
    tgt = torch.full((4, 3), 0.3)
    out = {cd: tt.fused_train_loss_grad(state, ro, rd, tgt, torch.ones(4),
                                        RenderSettings(n_samples=8), 10, 4, 3, 128,
                                        compute_dtype=cd)
           for cd in ("float32", "bfloat16")}
    loss, grads = out["bfloat16"]
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    assert abs(float(loss) - float(out["float32"][0])) > 1e-9


def test_train_kernel_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU never reaches the plain version; the
    CPU runs the plain version and launches nothing."""
    state = nerf_mlp_from_jax(_jax_params())
    args, opts = tt.train_objective_inputs(
        state, torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 3), torch.ones(4),
        RenderSettings(n_samples=8), 10, 4, N_LAYERS, HIDDEN)
    before = dict(tt.fused_train_objective.launches)
    meta = tuple(None if a is None else (tuple(p.to("meta") for p in a) if isinstance(a, tuple)
                                         else a.to("meta")) for a in args)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tt.fused_train_objective(*meta, **opts)
    loss, dpacked = tt.fused_train_objective(*args, **opts)
    assert torch.isfinite(loss) and len(dpacked) == 6
    assert tt.fused_train_objective.launches == before
