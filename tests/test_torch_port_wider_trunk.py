"""Trunk widths past 512 (640 and 1024): the port's plain versions of the
five kernels against the JAX package's Pallas kernels in interpret mode
(which take any width that is a multiple of 128), at ``compute_dtype``
``float32`` and ``bfloat16``, on the same numpy-seeded inputs (2-layer
trunk, pos_freq 10, 8 rays x 16 samples), the JAX side jitted; and one
reduced trainer epoch at width 640 through the port's kernel path on the
CPU against the JAX trainer through its interpret-mode train kernel, from
the JAX init carried by ``nerf_mlp_from_jax``. The CUDA kernels at these
widths (the width-generic build) are held to the plain versions on the
card (``tests/test_torch_port_cuda.py``).

Tolerances, as in ``test_torch_port_wide_trunk.py`` and with its reasons:
``float32`` is the exact fp32 function on both sides up to the order of the
sums: render outputs atol 1e-5 (depth, up to 6, 2e-5), gradient vectors rel
1e-4, losses rtol 1e-5. ``bfloat16``: both sides round both operands of
every product to bf16 and sum in fp32, so the bounds of
``test_torch_port_precision.py`` hold: outputs atol 1e-4, gradient vectors
rel 2e-4, losses rtol 1e-5. The trainer's per-step losses: rel 1e-4.
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
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

WIDTHS = (640, 1024)
N_LAYERS = 2
R, S = 8, 16
ROUTES = ("float32", "bfloat16")
OUT_ATOL = {"float32": {"rgb": 1e-5, "depth": 2e-5, "acc": 1e-5, "weights": 1e-5},
            "bfloat16": {"rgb": 1e-4, "depth": 1e-4, "acc": 1e-4, "weights": 1e-4}}
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-4}
LOSS_RTOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@functools.lru_cache(maxsize=None)
def _params(hidden, feat_dim=0, seed=0):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, dino_dim=feat_dim,
                       hidden_dim=hidden, num_layers=N_LAYERS, sigma_bias_init=0.1)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, feat_dim))] if feat_dim else [])
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(seed), *args)["params"])


def _rays(seed):
    """R rays from (0, 0, 4) into the scene volume, depths in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    return rng, ro, rd, z, dnorm


def _encoded(ro, rd, z):
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    return np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, True))


def _rel(got, want):
    flat = lambda ts: torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1)
                                 for t in ts])
    g, w = flat(got), flat(want)
    assert w.norm() > 1e-6
    return ((g - w).norm() / w.norm()).item()


def _fwd_pe(hidden, cd):
    """Kernel 2 with 64 point features: the port's outputs and JAX's."""
    rng, ro, rd, z, dnorm = _rays(1)
    perm, e2, c, x_dim = jk.pe_layout(10, 4, True, 64)
    packed = jk.pack_params(_params(hidden, 64), N_LAYERS, hidden, d_pad=-(-x_dim // 128) * 128,
                            row_perm=perm)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    raw = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    feats = rng.standard_normal((R * S, 64)).astype(np.float32)
    run = jax.jit(lambda *a: jk.fused_render_fwd_pe(*a[:6], a[6:], tile_rays=8, interpret=True,
                                                    compute_dtype=cd, use_feats=True))
    want = run(*map(jnp.asarray, (raw, feats, z, dnorm, e2, c, *packed)))
    got = tk.fused_render_fwd_pe(*map(_t, (raw, feats, z, dnorm, e2, c)),
                                 tuple(map(_t, packed)), compute_dtype=cd, use_feats=True)
    return got, want


def _fwd_x(hidden, cd):
    """Kernel 4 from the encoded x, white background."""
    _, ro, rd, z, dnorm = _rays(2)
    x = _encoded(ro, rd, z)
    packed = jk.pack_params(_params(hidden), N_LAYERS, hidden, d_pad=x.shape[1])
    run = jax.jit(lambda *a: jk.fused_render(*a, True, 8, True, cd))
    want = run(*map(jnp.asarray, (x, z, dnorm, *packed)))
    got = tk.fused_render_fwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)), True, cd)
    return got, want


def _render_bwd(hidden, cd):
    """Kernel 3: dx and the six packed gradients against ``jax.vjp`` of the
    JAX ``fused_render`` (its ``_bwd_kernel``), standard-normal cotangents."""
    rng, ro, rd, z, dnorm = _rays(3)
    x = _encoded(ro, rd, z)
    cot = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    packed = jk.pack_params(_params(hidden), N_LAYERS, hidden, d_pad=x.shape[1])

    @jax.jit
    def vjp(xx, zz, dn, p, ct):
        _, f = jax.vjp(lambda xv, *pv: jk.fused_render(xv, zz, dn, *pv, True, 8, True, cd),
                       xx, *p)
        return f(ct)

    want = vjp(*map(jnp.asarray, (x, z, dnorm)), tuple(map(jnp.asarray, packed)),
               tuple(map(jnp.asarray, cot)))
    dx, dpacked = tk.fused_render_bwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)),
                                      *map(_t, cot), white_bkgd=True, compute_dtype=cd)
    return (dx, *dpacked), want


def _objective(hidden, cd, inline_pe):
    """Kernels 1 (inline PE) and 5 (from x): the loss and packed gradients of
    the JAX ``_train_pe_call`` / ``_train_call`` (interpret mode) and of the
    port's ``fused_train_objective``, a white background, a masked tail and
    the w^2 and depth terms, both sides on the same points."""
    rng, ro, rd, z, dnorm = _rays(4)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (np.arange(R) < R - 2).astype(np.float32)[:, None]
    tgt_d = rng.uniform(2.5, 5.5, (R, 1)).astype(np.float32)
    inv = np.full((1, 1), 1.0 / (3.0 * mask.sum()), np.float32)
    loss_kw = dict(reg_weight=0.01, depth_weight=0.1)
    if inline_pe:
        perm, e2, c, _ = jk.pe_layout(10, 4, True, 0)
        packed = jk.pack_params(_params(hidden), N_LAYERS, hidden, d_pad=128, row_perm=perm)
        inp = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    else:
        packed = jk.pack_params(_params(hidden), N_LAYERS, hidden, d_pad=128)
        inp = _encoded(ro, rd, z)
    common = tuple(map(jnp.asarray, (z, dnorm, tgt, mask, inv)))
    jkw = dict(head_mode="mxu", dw_precision=None, **loss_kw)
    if inline_pe:
        feats = jnp.zeros((R * S, 8), jnp.float32)
        call = jax.jit(lambda i, cm, e, cc, p, td: jtk._train_pe_call(
            i, feats, *cm, e, cc, p, True, True, cd, False, tgt_depth=td, **jkw))
        want_loss, want = call(jnp.asarray(inp), common, jnp.asarray(e2), jnp.asarray(c),
                               tuple(map(jnp.asarray, packed)), jnp.asarray(tgt_d))
    else:
        call = jax.jit(lambda i, cm, p, td: jtk._train_call(i, *cm, p, True, True, cd,
                                                            tgt_depth=td, **jkw))
        want_loss, want = call(jnp.asarray(inp), common, tuple(map(jnp.asarray, packed)),
                               jnp.asarray(tgt_d))
    got_loss, got = tt.fused_train_objective(
        _t(inp), None, *map(_t, (z, dnorm, tgt, mask)), _t(inv.reshape(1)),
        *((_t(e2), _t(c)) if inline_pe else (None, None)), tuple(map(_t, packed)),
        white_bkgd=True, inline_pe=inline_pe, tgt_depth=_t(tgt_d), compute_dtype=cd, **loss_kw)
    return (float(got_loss), got), (float(np.asarray(want_loss).reshape(())), want)


@pytest.mark.parametrize("compute_dtype", ROUTES)
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x"])
def test_render_forward_at_wider_trunks_matches_jax(kernel, hidden, compute_dtype):
    """Kernels 2 and 4: rgb, depth, acc and weights."""
    got, want = (_fwd_pe if kernel == "fwd_pe" else _fwd_x)(hidden, compute_dtype)
    tol = OUT_ATOL[compute_dtype]
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert g.shape == tuple(w.shape), name
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        print(f"{kernel} H {hidden} {compute_dtype} {name}: max abs err vs JAX {err:.2e}")
        assert err <= tol[name], (name, err)


@pytest.mark.parametrize("compute_dtype", ROUTES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_render_vjp_at_wider_trunks_matches_jax(hidden, compute_dtype):
    """Kernel 3: dx and the six packed gradients as one vector."""
    got, want = _render_bwd(hidden, compute_dtype)
    rel = _rel(got, want)
    print(f"render_bwd H {hidden} {compute_dtype}: grad rel err vs JAX {rel:.2e}")
    assert rel <= GRAD_RTOL[compute_dtype]


@pytest.mark.parametrize("compute_dtype", ROUTES)
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("inline_pe", [True, False])
def test_train_objective_at_wider_trunks_matches_jax(inline_pe, hidden, compute_dtype):
    """Kernels 1 and 5: the loss and the six packed gradients as one vector."""
    (gl, gg), (wl, wg) = _objective(hidden, compute_dtype, inline_pe)
    rel = _rel(gg, wg)
    print(f"objective H {hidden} {compute_dtype} inline_pe {inline_pe}: loss rel "
          f"{abs(gl - wl) / abs(wl):.2e}, grad rel {rel:.2e}")
    assert [tuple(g.shape) for g in gg] == [tuple(np.shape(w)) for w in wg]
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
    assert rel <= GRAD_RTOL[compute_dtype]


def test_trainer_epoch_at_width_640_matches_jax(monkeypatch):
    """A reduced trainer at ``hidden_dim: 640`` (2 views at 16x16, 2 layers,
    12 samples, batches of 128: 4 steps): the JAX trainer through its
    interpret-mode train kernel against the port's kernel path on the CPU
    (the plain version of kernel 1; the generic build's width on a card),
    from the JAX init carried by ``nerf_mlp_from_jax``, jitter off; epoch
    0's per-step losses within rel 1e-4."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32, split="test")
    cfg = {
        "experiment": {"name": "port-wider"},
        "data": {"resolution": 16, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 640,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [{"start": 0, "H": 16, "n_samples": 12,
                                              "batch_size": 128}]},
        "rendering": {"chunk_size": 128},
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
    assert ptr._use_fused() and (ptr.kernel_path, ptr.kernel_path_reason) == ("kernel", None)
    ptr.model.load_state_dict(nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params)))
    assert ptr.model.state_dict()["trunk.1.weight"].shape == (640, 640)
    before = tt.fused_train_objective.launches["train_pe"]
    jtr.train_epoch(0)
    ptr.train_epoch(0)
    want = np.concatenate([s.reshape(-1) for s in step_losses])
    got = ptr.last_step_losses
    print(f"trainer H 640 epoch 0: {len(got)} steps, max rel "
          f"{np.max(np.abs(got - want) / np.abs(want)):.2e}")
    assert got.shape == want.shape == (2 * 2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # on the CPU the wrapper runs the plain version and launches nothing
    assert tt.fused_train_objective.launches["train_pe"] == before
