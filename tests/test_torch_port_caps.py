"""Past the caps the port's kernels once had (the JAX kernels never had
them): more than 1024 samples per ray, trunks deeper than 15 layers,
inputs wider than 896 columns. The port's plain versions of the kernels
against the JAX package's Pallas kernels in interpret mode on the same
numpy-seeded inputs, at ``compute_dtype`` ``float32``, and one reduced
trainer epoch at ``num_layers: 16`` through the port's kernel path on the
CPU against the JAX trainer through its interpret-mode train kernel. The
CUDA kernels at these shapes are held to the plain versions on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``'s caps phase).

Tolerances, as in ``test_torch_port_wide_trunk.py``: both sides are the
exact fp32 function up to the order of the sums: render outputs atol 1e-5
(depth, up to 6, 2e-5), gradient vectors rel 1e-4, losses rtol 1e-5; the
trainer's per-step losses rel 1e-4.
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
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

HIDDEN = 128
OUT_ATOL = {"rgb": 1e-5, "depth": 2e-5, "acc": 1e-5, "weights": 1e-5}
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
# (rays, samples, layers, features): past each cap, at H 128
SHAPES = {"samples_1040": (2, 1040, 3, 0), "layers_16": (8, 16, 16, 0),
          "width_1024": (8, 16, 3, 934)}  # 90 PE columns + 934 features: D 1024


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@functools.lru_cache(maxsize=None)
def _params(layers, feat_dim):
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, dino_dim=feat_dim,
                       hidden_dim=HIDDEN, num_layers=layers, sigma_bias_init=0.1)
    args = [jnp.zeros((1, 3)), jnp.zeros((1, 3))] + ([jnp.zeros((1, feat_dim))] if feat_dim else [])
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(7), *args)["params"])


def _rays(R, S, seed):
    """R rays from (0, 0, 4) into the scene volume, S sorted depths in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    dnorm = np.linalg.norm(rd, axis=-1, keepdims=True).astype(np.float32)
    return rng, ro, rd, z, dnorm


def _flat(ts):
    return torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1) for t in ts])


def _rel(got, want):
    g, w = _flat(got), _flat(want)
    assert w.norm() > 1e-6
    return ((g - w).norm() / w.norm()).item()


def _close_outputs(got, want, label):
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert g.shape == tuple(w.shape), name
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        print(f"{label} {name}: max abs err vs JAX {err:.2e}")
        assert err <= OUT_ATOL[name], (name, err)


def _encoded(ro, rd, z, feats):
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    f = None if feats is None else jnp.asarray(feats)
    return np.asarray(jfused.encode_points(jnp.asarray(pts), jnp.asarray(rd), 10, 4, True, f))


@pytest.mark.parametrize("case,inline_pe", [("samples_1040", True), ("layers_16", True),
                                            ("width_1024", True), ("width_1024", False)])
def test_train_objective_past_the_caps_matches_jax(case, inline_pe):
    """Kernel 1 (inline PE; at D 1024 also kernel 5, from an x 1024 wide):
    the loss and the six packed gradients, a white background, two masked
    rays, the w^2 and depth terms."""
    R, S, L, fd = SHAPES[case]
    rng, ro, rd, z, dnorm = _rays(R, S, 1)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    feats = rng.standard_normal((R * S, fd)).astype(np.float32) if fd else None
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (np.arange(R) < max(R - 2, 1)).astype(np.float32)[:, None]
    tgt_d = rng.uniform(2.5, 5.5, (R, 1)).astype(np.float32)
    inv = np.full((1, 1), 1.0 / (3.0 * mask.sum()), np.float32)
    loss_kw = dict(reg_weight=0.01, depth_weight=0.1)
    common = tuple(map(jnp.asarray, (z, dnorm, tgt, mask, inv)))
    jkw = dict(head_mode="mxu", tgt_depth=jnp.asarray(tgt_d), dw_precision=None, **loss_kw)
    if inline_pe:
        perm, e2, c, x_dim = jk.pe_layout(10, 4, True, fd)
        packed = jk.pack_params(_params(L, fd), L, HIDDEN, d_pad=tk.pe_width(x_dim),
                                row_perm=perm)
        inp = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
        jf = jnp.asarray(feats) if fd else jnp.zeros((R * S, 8), jnp.float32)
        want_loss, want = jtk._train_pe_call(jnp.asarray(inp), jf, *common, jnp.asarray(e2),
                                             jnp.asarray(c), packed, True, True, "float32",
                                             bool(fd), **jkw)
    else:
        inp = _encoded(ro, rd, z, feats)
        packed = jk.pack_params(_params(L, fd), L, HIDDEN, d_pad=inp.shape[1])
        want_loss, want = jtk._train_call(jnp.asarray(inp), *common, packed, True, True,
                                          "float32", **jkw)
    assert packed[0].shape[0] == (1024 if fd else 96 if inline_pe else 128)
    got_loss, got = tt.fused_train_objective(
        _t(inp), _t(feats) if (fd and inline_pe) else None, *map(_t, (z, dnorm, tgt, mask)),
        _t(inv.reshape(1)), *((_t(e2), _t(c)) if inline_pe else (None, None)),
        tuple(map(_t, packed)), white_bkgd=True, inline_pe=inline_pe, tgt_depth=_t(tgt_d),
        **loss_kw)
    wl = float(np.asarray(want_loss).reshape(()))
    rel = _rel(got, want)
    print(f"objective {case} inline_pe {inline_pe}: loss rel {abs(float(got_loss) - wl) / wl:.2e},"
          f" grad rel {rel:.2e}")
    np.testing.assert_allclose(float(got_loss), wl, rtol=LOSS_RTOL)
    assert rel <= GRAD_RTOL


def test_render_vjp_at_1040_samples_matches_jax():
    """Kernel 3 at 1040 samples per ray: dx and the six packed gradients
    against ``jax.vjp`` of the JAX ``fused_render`` (its ``_bwd_kernel``),
    standard-normal cotangents on all four outputs, a white background."""
    R, S, L, _ = SHAPES["samples_1040"]
    rng, ro, rd, z, dnorm = _rays(R, S, 2)
    x = _encoded(ro, rd, z, None)
    cot = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((R, 3), (R, 1), (R, 1), (R, S))]
    packed = jk.pack_params(_params(L, 0), L, HIDDEN, d_pad=x.shape[1])
    _, vjp = jax.vjp(lambda xx, *p: jk.fused_render(xx, jnp.asarray(z), jnp.asarray(dnorm), *p,
                                                    True, 2, True, "float32"),
                     jnp.asarray(x), *packed)
    want = vjp(tuple(map(jnp.asarray, cot)))
    dx, dpacked = tk.fused_render_bwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)),
                                      *map(_t, cot), white_bkgd=True)
    rel = _rel((dx, *dpacked), want)
    print(f"render_bwd S {S}: grad rel err vs JAX {rel:.2e}")
    assert rel <= GRAD_RTOL


def test_render_forward_at_16_layers_matches_jax():
    """Kernel 2 through a 16-layer trunk with 64 point features."""
    R, S, L, _ = SHAPES["layers_16"]
    rng, ro, rd, z, dnorm = _rays(R, S, 3)
    perm, e2, c, x_dim = jk.pe_layout(10, 4, True, 64)
    packed = jk.pack_params(_params(L, 64), L, HIDDEN, d_pad=-(-x_dim // 128) * 128,
                            row_perm=perm)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    raw = np.asarray(jk._raw_block(jnp.asarray(pts), jnp.asarray(rd), True))
    feats = rng.standard_normal((R * S, 64)).astype(np.float32)
    want = jk.fused_render_fwd_pe(*map(jnp.asarray, (raw, feats, z, dnorm, e2, c)), packed,
                                  tile_rays=8, interpret=True, use_feats=True)
    got = tk.fused_render_fwd_pe(*map(_t, (raw, feats, z, dnorm, e2, c)),
                                 tuple(map(_t, packed)), use_feats=True)
    _close_outputs(got, want, f"fwd_pe L {L}")


def test_render_forward_from_an_x_1024_wide_matches_jax():
    """Kernel 4 from an encoded x 1024 wide (934 point features), white
    background."""
    R, S, L, fd = SHAPES["width_1024"]
    rng, ro, rd, z, dnorm = _rays(R, S, 4)
    x = _encoded(ro, rd, z, rng.standard_normal((R * S, fd)).astype(np.float32))
    assert x.shape[1] == 1024
    packed = jk.pack_params(_params(L, fd), L, HIDDEN, d_pad=x.shape[1])
    want = jk.fused_render(*map(jnp.asarray, (x, z, dnorm)), *packed, True, 8, True, "float32")
    got = tk.fused_render_fwd(*map(_t, (x, z, dnorm)), tuple(map(_t, packed)), True)
    _close_outputs(got, want, "fwd x 1024")


def test_trainer_epoch_at_16_layers_matches_jax(monkeypatch):
    """A reduced trainer at ``num_layers: 16`` (2 views at 8x8, 128 wide,
    8 samples, batches of 32: 4 steps) takes the kernel path (no port gap
    any more); the JAX trainer through its interpret-mode train kernel
    against the port's kernel path on the CPU from the transplanted init
    with jitter off: epoch 0's per-step losses within rel 1e-4."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=8, gt_samples=16)
    test = jax_make_scene(jax_scene(), 2, img_size=8, gt_samples=16, split="test")
    cfg = {
        "experiment": {"name": "port-deep"},
        "data": {"resolution": 8, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": 16, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [{"start": 0, "H": 8, "n_samples": 8,
                                              "batch_size": 32}]},
        "rendering": {"chunk_size": 64},
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
    assert not hasattr(ptr, "_port_gap_reason") and ptr._jax_ineligible_reason() is None
    assert ptr._use_fused() and ptr.kernel_path == "kernel"
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    jtr.train_epoch(0)
    ptr.train_epoch(0)
    want = np.concatenate([s.reshape(-1) for s in step_losses])
    got = ptr.last_step_losses
    print(f"trainer 16 layers epoch 0: {len(got)} steps, max rel "
          f"{np.max(np.abs(got - want) / np.abs(want)):.2e}")
    assert got.shape == want.shape == (2 * 2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
