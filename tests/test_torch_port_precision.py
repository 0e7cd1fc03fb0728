"""The kernels' precision routes: ``compute_dtype`` ``bfloat16`` (both
operands of every product rounded to bf16, fp32 sums) and ``highest``
(exact fp32) in the port's plain versions of all five kernels, against the
JAX package's Pallas kernels in interpret mode on the same numpy-seeded
inputs (3x128 trunk, pos_freq 10, 16 rays x 16 samples), the objective's
two per-product pins, and a reduced trainer at ``bfloat16``.

Tolerances, with their reasons:
- ``highest`` is the exact fp32 function on both sides (JAX
  ``Precision.HIGHEST``, the port's fp32 matmuls), so it keeps the float32
  tests' bounds: render outputs atol 1e-5 (depth 2e-5); gradient vectors
  rel 1e-4; losses rtol 1e-5.
- ``bfloat16``: a bf16 x bf16 product is exact in fp32, so the two sides
  compute the same function but for the order of the fp32 sums. An
  activation that two orders round one fp32 ulp apart can round to
  neighbouring bf16 values (2^-8 apart). Both sides take the same inputs
  (each framework's own ray sampling would round ``o + d*z`` apart, and an
  ulp there moves the top PE band by ~2e-4 rad, past many bf16 roundings
  of x: rel 7e-4 in the gradients). Measured here (printed under ``-s``):
  outputs within 7.2e-6, gradient vectors within rel 2.0e-5 (the ``vpu``
  pin; 3e-7 without), losses within rel 2e-7; the bounds are outputs atol
  1e-4, gradient vectors rel 2e-4, losses rtol 1e-5. The reduced trainer
  samples its own rays on each side: its per-step losses read 1.8e-5,
  held to rel 1e-4.
- The guard: on the same inputs the ``bfloat16`` plain version sits at
  least 3e-4 (outputs) and rel 3e-3 (gradients) from the ``float32`` one
  (measured 9.0e-4, 1.0e-2 and 1.3e-2), so a route that ignored the dtype
  fails the bounds above; each pin moves the result by more than ten times
  its distance from JAX's (measured 1.0e-3 and 1.8e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.render import fused as jfused
from nerf_fewshot_tpu.render import kernels as jk
from nerf_fewshot_tpu.render import train_kernel as jtk
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

HIDDEN, N_LAYERS = 128, 3
R, S = 16, 16
ROUTES = ("bfloat16", "highest")
OUT_ATOL = {"bfloat16": 1e-4, "highest": 1e-5}
GRAD_RTOL = {"bfloat16": 2e-4, "highest": 1e-4}
LOSS_RTOL = {"bfloat16": 1e-5, "highest": 1e-5}
GUARD_OUT, GUARD_GRAD = 3e-4, 3e-3


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _params(feat_dim=0, seed=0):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, dino_dim=feat_dim,
                       hidden_dim=HIDDEN, num_layers=N_LAYERS, sigma_bias_init=0.1)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, feat_dim))] if feat_dim else [])
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(seed), *args)["params"])


def _rays(seed):
    """R rays from (0, 0, 4) into the scene volume, depths in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    return rng, ro, rd, z


def _x_inputs(seed):
    """The encoded (R*S, 128) x, z, dnorm and standard-normal cotangents."""
    rng, ro, rd, z = _rays(seed)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x = np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, True))
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    cot = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    return x, z, dnorm, cot


def _max_err(got, want):
    return max(float(np.abs(g.detach().numpy() - np.asarray(w)).max()) for g, w in zip(got, want))


def _rel(got, want):
    g = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1) for t in got])
    w = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1) for t in want])
    assert w.norm() > 1e-6
    return ((g - w).norm() / w.norm()).item()


@pytest.mark.parametrize("compute_dtype", ROUTES)
def test_fwd_pe_route_matches_jax(compute_dtype):
    """Kernel 2 (``fused_render_fwd_pe``) with 64 point features."""
    rng, ro, rd, z = _rays(1)
    params = _params(feat_dim=64)
    perm, e2, c, x_dim = jk.pe_layout(10, 4, True, 64)
    packed = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=-(-x_dim // 128) * 128, row_perm=perm)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    raw = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    feats = rng.standard_normal((R * S, 64)).astype(np.float32)
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    want = jk.fused_render_fwd_pe(*map(jnp.asarray, (raw, feats, z, dnorm, e2, c)), packed,
                                  tile_rays=8, interpret=True, compute_dtype=compute_dtype,
                                  use_feats=True)
    args = (*map(_t, (raw, feats, z, dnorm, e2, c)), tuple(map(_t, packed)))
    got = tk.fused_render_fwd_pe(*args, compute_dtype=compute_dtype, use_feats=True)
    err = _max_err(got, want)
    print(f"fwd_pe {compute_dtype}: max abs err vs JAX {err:.2e}")
    assert err <= OUT_ATOL[compute_dtype]


@pytest.mark.parametrize("compute_dtype", ROUTES)
def test_fwd_x_route_matches_jax(compute_dtype, white_bkgd=True):
    """Kernel 4 (``fused_render_fwd``) from the encoded x, white background."""
    x, z, dnorm, _ = _x_inputs(2)
    packed = jk.pack_params(_params(), N_LAYERS, HIDDEN, d_pad=x.shape[1])
    want = jk.fused_render(*map(jnp.asarray, (x, z, dnorm)), *packed, white_bkgd, 8, True,
                           compute_dtype)
    got = tk.fused_render_fwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)), white_bkgd,
                              compute_dtype)
    err = _max_err(got, want)
    print(f"fwd_x {compute_dtype} white {white_bkgd}: max abs err vs JAX {err:.2e}")
    assert err <= OUT_ATOL[compute_dtype]


@pytest.mark.parametrize("compute_dtype", ROUTES)
def test_render_vjp_route_matches_jax(compute_dtype):
    """Kernel 3 (``fused_render_bwd``): dx and the six packed gradients
    against ``jax.vjp`` of the JAX ``fused_render`` (its ``_bwd_kernel``)
    at the same route; and the differentiable ``fused_render`` takes the
    route through to kernel 3's plain version."""
    x, z, dnorm, cot = _x_inputs(3)
    packed = jk.pack_params(_params(), N_LAYERS, HIDDEN, d_pad=x.shape[1])

    def jax_fn(xx, *p):
        return jk.fused_render(xx, jnp.asarray(z), jnp.asarray(dnorm), *p, True, 8, True,
                               compute_dtype)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x), *packed)
    want = vjp(tuple(map(jnp.asarray, cot)))
    dx, dpacked = tk.fused_render_bwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)),
                                      *map(_t, cot), white_bkgd=True, compute_dtype=compute_dtype)
    rel = _rel((dx, *dpacked), want)
    print(f"render_bwd {compute_dtype}: grad rel err vs JAX {rel:.2e}")
    assert rel <= GRAD_RTOL[compute_dtype]
    leaves = [_t(p).requires_grad_(True) for p in packed]
    xt = _t(x).requires_grad_(True)
    outs = tk.fused_render(xt, _t(z), _t(dnorm), tuple(leaves), white_bkgd=True,
                           compute_dtype=compute_dtype)
    torch.autograd.backward(outs, list(map(_t, cot)))
    for a, b in zip((xt.grad, *(p.grad for p in leaves)), (dx, *dpacked)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _objective(compute_dtype, inline_pe, seed=4, **pins):
    """Loss and packed gradients of the JAX objective kernel (``_train_pe_call``
    or ``_train_call``, interpret mode) and of the port's
    ``fused_train_objective`` on the same inputs (a white background, a
    masked tail, the w^2 and depth terms), as ``(loss, [six tensors])``
    pairs. Both sides take the same points: each framework's own sampling
    rounds ``o + d*z`` its own way, and at ``bfloat16`` the ulp that moves
    the top PE band by ~2e-4 rad moves a bf16 rounding of x."""
    rng, ro, rd, z = _rays(seed)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (np.arange(R) < R - 3).astype(np.float32)[:, None]
    tgt_d = rng.uniform(2.5, 5.5, (R, 1)).astype(np.float32)
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    inv = np.full((1, 1), 1.0 / (3.0 * mask.sum()), np.float32)
    params = _params()
    loss_kw = dict(reg_weight=0.01, depth_weight=0.1)
    if inline_pe:
        perm, e2, c, _ = jk.pe_layout(10, 4, True, 0)
        packed = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=128, row_perm=perm)
        inp = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    else:
        packed = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=128)
        inp = np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, True))
    vpu = pins.get("head_mode") == "vpu"
    jpacked = (*packed[:4], *jtk._to_vpu_head(*packed[4:])) if vpu else packed
    jkw = dict(head_mode=pins.get("head_mode", "mxu"), tgt_depth=jnp.asarray(tgt_d),
               dw_precision=(jax.lax.Precision.HIGHEST if "dw_precision" in pins else None),
               **loss_kw)
    common = tuple(map(jnp.asarray, (z, dnorm, tgt, mask, inv)))
    if inline_pe:
        feats = jnp.zeros((R * S, 8), jnp.float32)
        want_loss, want = jtk._train_pe_call(jnp.asarray(inp), feats, *common, jnp.asarray(e2),
                                             jnp.asarray(c), jpacked, True, True, compute_dtype,
                                             False, **jkw)
    else:
        want_loss, want = jtk._train_call(jnp.asarray(inp), *common, jpacked, True, True,
                                          compute_dtype, **jkw)
    want = [np.asarray(w) for w in want]
    if vpu:  # the JAX row-layout head back to the packed columns
        dwout, dbout = np.zeros((HIDDEN, 128), np.float32), np.zeros((1, 128), np.float32)
        dwout[:, :4], dbout[:, :4] = want[4][:4].T, want[5][:, :4]
        want[4:] = [dwout, dbout]
    got_loss, got = tt.fused_train_objective(
        _t(inp), None, *map(_t, (z, dnorm, tgt, mask)), _t(inv.reshape(1)),
        *((_t(e2), _t(c)) if inline_pe else (None, None)), tuple(map(_t, packed)),
        white_bkgd=True, inline_pe=inline_pe, tgt_depth=_t(tgt_d), compute_dtype=compute_dtype,
        **loss_kw, **pins)
    return (float(got_loss), list(got)), (float(np.asarray(want_loss).reshape(())), want)


@pytest.mark.parametrize("inline_pe", [True, False])
@pytest.mark.parametrize("compute_dtype", ROUTES)
def test_train_objective_route_matches_jax(compute_dtype, inline_pe):
    """Kernels 1 (inline PE) and 5 (from x): ``fused_train_objective``."""
    (gl, gg), (wl, wg) = _objective(compute_dtype, inline_pe)
    rel = _rel(gg, wg)
    print(f"objective {compute_dtype} inline_pe {inline_pe}: loss rel "
          f"{abs(gl - wl) / abs(wl):.2e}, grad rel {rel:.2e}")
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL[compute_dtype])
    assert rel <= GRAD_RTOL[compute_dtype]


@pytest.mark.parametrize("pins", [dict(dw_precision="highest"), dict(head_mode="vpu")])
def test_objective_pins_match_jax(pins):
    """The JAX entry's per-product pins under ``bfloat16``: the six dW
    products (``dw_precision``) or the head (``head_mode="vpu"``) in exact
    fp32. Each pin moves the port's result off the unpinned route by about
    as much as it moves the JAX one."""
    (gl, gg), (wl, wg) = _objective("bfloat16", True, **pins)
    rel = _rel(gg, wg)
    (_, ug), _ = _objective("bfloat16", True)
    print(f"objective bfloat16 {pins}: loss rel {abs(gl - wl) / abs(wl):.2e}, grad rel "
          f"{rel:.2e}, pinned vs unpinned {_rel(gg, ug):.2e}")
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL["bfloat16"])
    assert rel <= GRAD_RTOL["bfloat16"]
    assert _rel(gg, ug) > 10 * rel


def test_pins_refuse_unknown_values():
    args, opts = tt.train_objective_inputs(
        nerf_mlp_from_jax(_params()), torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 3),
        torch.ones(4), RenderSettings(n_samples=8), 10, 4, N_LAYERS, HIDDEN)
    for bad in (dict(dw_precision="default"), dict(head_mode="mxu2")):
        with pytest.raises(ValueError, match="dw_precision|head_mode"):
            tt.fused_train_objective(*args, **{**opts, **bad})
    with pytest.raises(ValueError, match="compute_dtype"):
        tt.fused_train_objective(*args, **{**opts, "compute_dtype": "float16"})


def test_bfloat16_route_is_apart_from_float32():
    """The guard: on the same inputs the ``bfloat16`` plain versions sit
    measurably away from the ``float32`` ones (outputs of kernel 4, the
    gradients of kernel 3 and of the objective), farther than the bounds
    that hold them to JAX's ``bfloat16``."""
    x, z, dnorm, cot = _x_inputs(2)
    packed = tuple(map(_t, jk.pack_params(_params(), N_LAYERS, HIDDEN, d_pad=x.shape[1])))
    args = tuple(map(_t, (x, z, dnorm)))
    out = {cd: tk.fused_render_fwd(*args, packed, False, cd) for cd in ("float32", "bfloat16")}
    grads = {cd: (lambda r: (r[0], *r[1]))(tk.fused_render_bwd(*args, packed, *map(_t, cot),
                                                                compute_dtype=cd))
             for cd in ("float32", "bfloat16")}
    (_, g32), _ = _objective("float32", True)
    (_, g16), _ = _objective("bfloat16", True)
    apart = (_max_err(out["bfloat16"], [t.numpy() for t in out["float32"]]),
             _rel(grads["bfloat16"], grads["float32"]), _rel(g16, g32))
    print(f"bfloat16 vs float32: outputs {apart[0]:.2e}, render VJP rel {apart[1]:.2e}, "
          f"objective rel {apart[2]:.2e}")
    assert apart[0] > GUARD_OUT and apart[1] > GUARD_GRAD and apart[2] > GUARD_GRAD
    assert GUARD_OUT > OUT_ATOL["bfloat16"] and GUARD_GRAD > GRAD_RTOL["bfloat16"]


def test_trainer_bfloat16_epoch_matches_jax(monkeypatch):
    """A reduced trainer (2 views at 16x16, 3x128, 8 samples, batches of
    48) at ``rendering.compute_dtype: bfloat16``: the JAX trainer through
    its interpret-mode kernel against the port's kernel path on the CPU,
    from the transplanted init with jitter off; epoch 0's per-step losses
    within rel 1e-4."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32, split="test")
    cfg = {
        "experiment": {"name": "port-bf16"},
        "data": {"resolution": 16, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [{"start": 0, "H": 16, "n_samples": 8,
                                              "batch_size": 48}]},
        "rendering": {"chunk_size": 128, "compute_dtype": "bfloat16"},
        "seed": 0,
    }
    jtr = jax_trainer_mod.Trainer(jcfg.config_from_dict(cfg), train, test)
    assert jtr._kernel_eligible()
    step_losses = []
    make = jtr._make_step_fn

    def capturing(phase_idx):
        fn = make(phase_idx)

        def step(*a):
            out = fn(*a)
            step_losses.append(np.asarray(out[2]))
            return out
        return step

    monkeypatch.setattr(jtr, "_make_step_fn", capturing)
    data = lambda ds: BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W,
                                     ds.focal)
    ptr = Trainer(tcfg.config_from_dict(cfg), data(train), data(test), device="cpu")
    assert ptr._use_fused() and ptr.kernel_path == "kernel"
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    jtr.train_epoch(0)
    ptr.train_epoch(0)
    want = np.concatenate([s.reshape(-1) for s in step_losses])
    got = ptr.last_step_losses
    print(f"trainer bfloat16 epoch 0: {len(got)} steps, max rel "
          f"{np.max(np.abs(got - want) / np.abs(want)):.2e}")
    assert got.shape == want.shape == (2 * 6,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
