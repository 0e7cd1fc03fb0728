"""Trunk widths 384 and 512: the port's plain versions of the five kernels
against the JAX package's Pallas kernels in interpret mode (which take any
width that is a multiple of 128), at ``compute_dtype`` ``float32`` and
``bfloat16``, on the same numpy-seeded inputs (3-layer trunk, pos_freq 10,
8 rays x 16 samples), and one reduced trainer epoch at width 512 through
the port's kernel path on the CPU against the JAX trainer through its
interpret-mode train kernel. The CUDA kernels at these widths are held to
the plain versions on the card (``tests/test_torch_port_cuda.py``).

Tolerances, with their reasons: ``float32`` is the exact fp32 function on
both sides up to the order of the sums, as in the float32 port tests:
render outputs atol 1e-5 (depth, up to 6, 2e-5), gradient vectors rel 1e-4,
losses rtol 1e-5. ``bfloat16``: both sides round both operands of every
product to bf16 and sum in fp32; an activation that the two sum orders
round one ulp apart can land on neighbouring bf16 values, so the bounds of
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
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

WIDTHS = (384, 512)
N_LAYERS = 3
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


def _flat(ts):
    return torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1) for t in ts])


def _rel(got, want):
    g, w = _flat(got), _flat(want)
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
    want = jk.fused_render_fwd_pe(*map(jnp.asarray, (raw, feats, z, dnorm, e2, c)), packed,
                                  tile_rays=8, interpret=True, compute_dtype=cd, use_feats=True)
    got = tk.fused_render_fwd_pe(*map(_t, (raw, feats, z, dnorm, e2, c)),
                                 tuple(map(_t, packed)), compute_dtype=cd, use_feats=True)
    return got, want


def _fwd_x(hidden, cd):
    """Kernel 4 from the encoded x, white background."""
    _, ro, rd, z, dnorm = _rays(2)
    x = _encoded(ro, rd, z)
    packed = jk.pack_params(_params(hidden), N_LAYERS, hidden, d_pad=x.shape[1])
    want = jk.fused_render(*map(jnp.asarray, (x, z, dnorm)), *packed, True, 8, True, cd)
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
    _, vjp = jax.vjp(lambda xx, *p: jk.fused_render(xx, jnp.asarray(z), jnp.asarray(dnorm), *p,
                                                    True, 8, True, cd),
                     jnp.asarray(x), *packed)
    want = vjp(tuple(map(jnp.asarray, cot)))
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
    jkw = dict(head_mode="mxu", tgt_depth=jnp.asarray(tgt_d), dw_precision=None, **loss_kw)
    if inline_pe:
        feats = jnp.zeros((R * S, 8), jnp.float32)
        want_loss, want = jtk._train_pe_call(jnp.asarray(inp), feats, *common, jnp.asarray(e2),
                                             jnp.asarray(c), packed, True, True, cd, False,
                                             **jkw)
    else:
        want_loss, want = jtk._train_call(jnp.asarray(inp), *common, packed, True, True, cd,
                                          **jkw)
    got_loss, got = tt.fused_train_objective(
        _t(inp), None, *map(_t, (z, dnorm, tgt, mask)), _t(inv.reshape(1)),
        *((_t(e2), _t(c)) if inline_pe else (None, None)), tuple(map(_t, packed)),
        white_bkgd=True, inline_pe=inline_pe, tgt_depth=_t(tgt_d), compute_dtype=cd, **loss_kw)
    return (float(got_loss), got), (float(np.asarray(want_loss).reshape(())), want)


@pytest.mark.parametrize("compute_dtype", ROUTES)
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x"])
def test_render_forward_at_wide_trunks_matches_jax(kernel, hidden, compute_dtype):
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
def test_render_vjp_at_wide_trunks_matches_jax(hidden, compute_dtype):
    """Kernel 3: dx and the six packed gradients as one vector."""
    got, want = _render_bwd(hidden, compute_dtype)
    rel = _rel(got, want)
    print(f"render_bwd H {hidden} {compute_dtype}: grad rel err vs JAX {rel:.2e}")
    assert rel <= GRAD_RTOL[compute_dtype]


@pytest.mark.parametrize("compute_dtype", ROUTES)
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("inline_pe", [True, False])
def test_train_objective_at_wide_trunks_matches_jax(inline_pe, hidden, compute_dtype):
    """Kernels 1 and 5: the loss and the six packed gradients as one vector."""
    (gl, gg), (wl, wg) = _objective(hidden, compute_dtype, inline_pe)
    rel = _rel(gg, wg)
    print(f"objective H {hidden} {compute_dtype} inline_pe {inline_pe}: loss rel "
          f"{abs(gl - wl) / abs(wl):.2e}, grad rel {rel:.2e}")
    assert [tuple(g.shape) for g in gg] == [tuple(np.shape(w)) for w in wg]
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
    assert rel <= GRAD_RTOL[compute_dtype]


def test_trainer_epoch_at_width_512_matches_jax(monkeypatch):
    """A reduced trainer at ``hidden_dim: 512`` (2 views at 16x16, 3 layers,
    12 samples, batches of 96: 6 steps): the JAX trainer through its
    interpret-mode train kernel against the port's kernel path on the CPU
    (the plain version of kernel 1), from the transplanted init with jitter
    off; epoch 0's per-step losses within rel 1e-4 (read 2e-6)."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32, split="test")
    cfg = {
        "experiment": {"name": "port-wide"},
        "data": {"resolution": 16, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 512,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [{"start": 0, "H": 16, "n_samples": 12,
                                              "batch_size": 96}]},
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
    assert ptr._use_fused() and ptr.kernel_path == "kernel"
    assert not hasattr(ptr, "_port_gap_reason") and ptr.kernel_path_reason is None
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    before = tt.fused_train_objective.launches["train_pe"]
    jtr.train_epoch(0)
    ptr.train_epoch(0)
    want = np.concatenate([s.reshape(-1) for s in step_losses])
    got = ptr.last_step_losses
    print(f"trainer H 512 epoch 0: {len(got)} steps, max rel "
          f"{np.max(np.abs(got - want) / np.abs(want)):.2e}")
    assert got.shape == want.shape == (2 * 3,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # on the CPU the wrapper runs the plain version and launches nothing
    assert tt.fused_train_objective.launches["train_pe"] == before


def _compiled_samples(rays_o, rays_d, near, far, n_samples, uniforms=None, lindisp=False):
    """``sample_along_rays`` without jitter, rounded as XLA compiles the JAX
    sampler at the shapes of the test below: ``jnp.linspace(0, 1, n)`` as
    ``i * (1 / (n - 1))``, then ``near * (1 - t) + far * t`` and ``o + d * z``
    each one fused multiply-add (the product exact in float64, one rounding
    of the sum). The JAX function called op by op fuses nothing, and the
    port's rounds as that does."""
    assert uniforms is None and not lindisp
    f64 = lambda t: t.double()
    t = torch.arange(n_samples, dtype=torch.float32) * (1.0 / (n_samples - 1))
    t[-1] = 1.0
    z = (far * f64(t) + f64(near * (1.0 - t))).float()
    z = z.expand(rays_o.shape[:-1] + (n_samples,))
    pts = (f64(rays_d)[..., None, :] * f64(z)[..., :, None] + f64(rays_o)[..., None, :]).float()
    return pts, z


def test_trainer_steps_at_width_512_batches_of_48_match_jax(monkeypatch, tmp_path):
    """The trainer of ``test_trainer_epoch_at_width_512_matches_jax`` at
    batches of 48 (2 views x 6 steps), step by step from a shared state:
    before each step the JAX trainer's params and Adam state go into the
    port (``Trainer.load_jax_checkpoint``: ``load_jax_params`` and its Adam
    mapping), then both take that step on the minibatch of the epoch's
    permutation (jitter off): the JAX ``fused_train_loss_grad`` (its
    interpret-mode train kernel) and its optax chain, jitted as the JAX
    trainer compiles its step, against the port trainer's kernel-path step
    and ``torch.optim.Adam``.

    With the port's own samples the losses agree (rtol 1e-5) but the
    gradients do not: up to rel 3.4e-4, and 68 of Adam's first updates more
    than lr/2 apart (the early updates are ~lr whatever the gradient's size,
    and those gradients are tiny beside the norm: printed). The samples differ by an
    ulp: the compiled JAX step fuses the multiply-adds of its sampler, the
    port (like the JAX sampler called op by op) does not, and the PE's 2^9
    band takes an ulp of a point to ~2e-4 rad of phase. (The rays, an ulp
    apart too before, are bit-equal now: ``phase_rays``.) On the JAX
    step's own samples (``_compiled_samples``, checked bit-equal to the
    jitted JAX sampler) every step agrees: loss rtol 1e-5, gradients as one
    vector rel 1e-4 (read at most 8.3e-6), the updated params rel 1e-5
    (1.5e-6 after Adam's first step, at most 1.7e-7 after), no update lr/2
    apart; and the free epoch from the init agrees per step within rel 1e-4
    (read 1.0e-5, against 2.9e-4 on the port's samples)."""
    from nerf_fewshot_tpu.ops.sampling import sample_along_rays as jax_samples
    from nerf_fewshot_tpu.render.train_kernel import fused_train_loss_grad as jax_loss_grad
    from nerf_fewshot_tpu.training.optim import set_learning_rate
    from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax

    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    for cls in (jax_trainer_mod.Trainer, Trainer):
        orig = cls._render_settings
        monkeypatch.setattr(cls, "_render_settings",
                            lambda self, n, training, orig=orig: orig(self, n, False))
    train = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=16, gt_samples=32, split="test")
    B, S = 48, 12
    cfg = {
        "experiment": {"name": "port-wide"},
        "data": {"resolution": 16, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 512,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        "training": {"epochs": 1, "phases": [{"start": 0, "H": 16, "n_samples": S,
                                              "batch_size": B}]},
        "rendering": {"chunk_size": 128},
        "seed": 0,
    }
    data = lambda ds: BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W,
                                     ds.focal)
    jtr = jax_trainer_mod.Trainer(jcfg.config_from_dict(cfg), train, test)
    ptr = Trainer(tcfg.config_from_dict(cfg), data(train), data(test), device="cpu")
    assert jtr._kernel_eligible() and ptr._use_fused() and ptr.kernel_path == "kernel"
    init = jax.tree_util.tree_map(np.asarray, jtr.params)
    lr = jtr.lr_at(0)
    js, ps = jtr._render_settings(S, training=True), ptr._render_settings(S, training=True)

    @jax.jit
    def jax_step(params, opt_state, ro, rd, tgt, mask):
        loss, grads = jax_loss_grad(params, ro, rd, tgt, mask, js, pos_freq=10, dir_freq=4,
                                    num_layers=N_LAYERS, hidden_dim=512, use_viewdirs=True,
                                    lora_alpha=jtr.cfg.nerf.lora_alpha, interpret=True)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        return loss, grads, jax.tree_util.tree_map(lambda q, u: q + u, params, updates), opt_state

    jax_pts = jax.jit(lambda o, d: jax_samples(o, d, 2.0, 6.0, S)[0])
    names = list(nerf_mlp_from_jax(init))
    flat = lambda tree: torch.cat([torch.as_tensor(np.asarray(tree[k], np.float64)).reshape(-1)
                                   for k in names])
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    jpd, ppd = jtr.phase_data(0), ptr.phase_data(0)
    for a, b in ((jpd.rays_o, ppd.rays_o), (jpd.rays_d, ppd.rays_d), (jpd.targets, ppd.targets)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n_rays = ppd.rays_o.shape[1]
    n_batches = -(-n_rays // B)
    perms = np.random.default_rng(cfg["seed"])  # the trainers' permutations
    set_learning_rate(jtr.opt_state, lr)
    ckpt = str(tmp_path / "state.ckpt")
    own = tt.sample_along_rays
    readings = {"own": [], "compiled": []}
    for v in range(2):
        perm = perms.permutation(n_rays)
        idxs = np.concatenate([perm, np.zeros(n_batches * B - n_rays, perm.dtype)])
        masks = (np.arange(n_batches * B) < n_rays).astype(np.float32)
        for b in range(n_batches):
            idx, mask = idxs[b * B:(b + 1) * B], masks[b * B:(b + 1) * B]
            jtr.save(ckpt)
            old_j = flat(nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params)))
            jl, jg, new, jtr.opt_state = jax_step(
                jtr.params, jtr.opt_state, jpd.rays_o[v][idx], jpd.rays_d[v][idx],
                jpd.targets[v][idx], jnp.asarray(mask))
            jtr.params = new
            g_j = flat(nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jg)))
            new_j = flat(nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, new)))
            it = torch.as_tensor(idx)
            ro, rd = ppd.rays_o[v][it], ppd.rays_d[v][it]
            np.testing.assert_array_equal(_compiled_samples(ro, rd, 2.0, 6.0, S)[0].numpy(),
                                          np.asarray(jax_pts(jnp.asarray(ro), jnp.asarray(rd))))
            for which, sampler in (("own", own), ("compiled", _compiled_samples)):
                monkeypatch.setattr(tt, "sample_along_rays", sampler)
                ptr.load_jax_checkpoint(ckpt)
                pl = ptr._kernel_loss_grad(ro, rd, ppd.targets[v][it], torch.as_tensor(mask), ps,
                                           dict.fromkeys(("uniforms", "importance_uniforms")), v)
                g_p = flat({n: p.grad for n, p in ptr.model.named_parameters()})
                ptr.optimizer.step()
                new_p = flat({n: p.detach() for n, p in ptr.model.named_parameters()})
                du = (new_p - new_j).abs()  # the two updates' difference, from one state
                flips = torch.nonzero(du > lr / 2).reshape(-1)
                readings[which].append((abs(float(pl) / float(jl) - 1.0), rel(g_p, g_j),
                                        rel(new_p, new_j), len(flips)))
                print(f"step {len(readings[which]) - 1} on the {which} samples: loss rel "
                      "%.2e, grad rel %.2e, params rel %.2e, %d updates > lr/2"
                      % readings[which][-1])
                if len(flips):
                    frac = g_j[flips].abs() / g_j.norm()
                    print(f"    their JAX gradients: {frac.min().item():.1e} to "
                          f"{frac.max().item():.1e} of the gradient's norm")
                for i in flips[:4].tolist():
                    print(f"    element {i}: gradient {g_j[i].item():.2e} (JAX), "
                          f"{g_p[i].item():.2e} (port): {abs(g_j[i].item()) / g_j.norm().item():.1e}"
                          f" of the norm; update {new_j[i].item() - old_j[i].item():.2e} (JAX), "
                          f"{new_p[i].item() - old_j[i].item():.2e} (port)")
    assert len(readings["own"]) == 2 * 6
    assert max(r[0] for r in readings["own"]) <= 1e-5
    for step, (loss_rel, grad_rel, params_rel, flips) in enumerate(readings["compiled"]):
        assert loss_rel <= 1e-5 and grad_rel <= 1e-4, (step, loss_rel, grad_rel)
        assert params_rel <= 1e-5 and flips == 0, (step, params_rel, flips)

    # the free epoch from the init on fresh trainers, the port on the JAX step's samples
    jtr = jax_trainer_mod.Trainer(jcfg.config_from_dict(cfg), train, test)
    ptr = Trainer(tcfg.config_from_dict(cfg), data(train), data(test), device="cpu")
    ptr.load_jax_params(init)
    step_losses = []
    make = jtr._make_step_fn

    def capturing(phase_idx):
        fn = make(phase_idx)

        def step_fn(*a):
            out = fn(*a)
            step_losses.append(np.asarray(out[2]))
            return out
        return step_fn

    monkeypatch.setattr(jtr, "_make_step_fn", capturing)
    jtr.train_epoch(0)
    ptr.train_epoch(0)
    want = np.concatenate([s.reshape(-1) for s in step_losses])
    got = ptr.last_step_losses
    print(f"free epoch at batches of {B} on the JAX step's samples: {len(got)} steps, max rel "
          f"{np.max(np.abs(got - want) / np.abs(want)):.2e}")
    assert got.shape == want.shape == (2 * 6,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("hidden", [640, 768])
def test_wider_trunks_are_the_ports_gap(hidden):
    """The JAX kernels take any multiple of 128, and so, since the
    width-generic build, do the port's CUDA kernels: a trainer at these
    widths takes the kernel path with no reason recorded, on the CPU and as
    the choice a card makes (the gap this test once named is closed; the
    kernels at these widths are held to their plain versions on the card in
    ``tests/test_torch_port_cuda.py``)."""
    cfg = tcfg.config_from_dict({"nerf_model": {"hidden_dim": hidden, "num_layers": 2}})
    data = BlenderDataset(np.zeros((1, 4, 4, 3), np.float32), np.eye(4, dtype=np.float32)[None],
                          4, 4, 4.0)
    tr = Trainer(cfg, data, device="cpu")
    assert tr._jax_ineligible_reason() is None and not hasattr(tr, "_port_gap_reason")
    assert tr._use_fused() and (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)
    tr.device = torch.device("cuda", 0)
    assert tr._use_fused() and (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)
    assert not hasattr(tk, "KERNEL_WIDTHS") and hidden % tk.H_ALIGN == 0
