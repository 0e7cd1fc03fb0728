"""Trunk LoRA, skip layers and the two-phase freeze of the port against the
JAX package on the same numpy-seeded inputs: ``NeRFMLP`` with
``skip_layers`` and ``lora_rank``, the LoRA merge of ``pack_params``,
``fused_train_loss_grad`` and the eval render of a LoRA model (the JAX
side running its Pallas kernels in interpret mode), ``make_optimizer(
lora_only=True)`` against the JAX ``multi_transform`` chain, and the
two-phase trainer against the JAX CPU trainer.

LoRA's ``lora_b`` starts at zero; every comparison below sets it to
``N(0, 0.05^2)`` values first, so the update is live. Tolerances, with
their reasons:
- the MLP: rtol 1e-5 / atol 2e-5, as ``test_torch_port_models.py`` (fp32
  sums in other orders);
- ``pack_params``: atol 1e-6 (the merge's r = 4 products summed in another
  order; the merged weights are ~0.1);
- the objective and the eval render: the bounds of
  ``test_torch_port_train_objective.py`` and ``test_torch_port_kernels.py``
  (loss rtol 1e-5; gradients per leaf rtol 1e-3 / atol 1e-6 of the leaf's
  scale and as one vector rel 1e-4; render rtol 2e-4 / atol 2e-5);
- ``lora_only``: float64, rtol 1e-10, as ``test_torch_port_train_optim.py``;
- the trainer: epoch losses rtol 1e-4 and the parameter change as one
  vector rel 2e-3, as ``test_torch_port_train_trainer.py``; the frozen
  parameters bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP
from nerf_fewshot_tpu.render import fused as jfused
from nerf_fewshot_tpu.render import kernels as jk
from nerf_fewshot_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerf_fewshot_tpu.render.train_kernel import fused_train_loss_grad as jax_loss_grad
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu.training import optim as joptim
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.lora import lora_label_fn
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import optim as toptim
from nerf_fewshot_tpu_torch.training.trainer import Trainer

HIDDEN, N_LAYERS, RANK, ALPHA = 128, 3, 4, 16.0
RNG = np.random.default_rng(31)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_params(seed=0, rank=RANK, skip=(), live_b=True, **kw):
    """A JAX ``NeRFMLP`` tree (numpy leaves), ``lora_b`` set live."""
    model = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=HIDDEN,
                       num_layers=N_LAYERS, lora_rank=rank, lora_alpha=ALPHA, skip_layers=skip,
                       sigma_bias_init=0.1, **kw)
    zeros = jnp.zeros((1, 3))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.key(seed), zeros, zeros)["params"])
    if rank and live_b:
        rng = np.random.default_rng(seed + 100)
        for i in range(N_LAYERS):
            b = params[f"trunk_{i}"]["lora_b"]
            params[f"trunk_{i}"]["lora_b"] = (0.05 * rng.standard_normal(b.shape)).astype(
                np.float32)
    return model, params


@pytest.mark.parametrize("skip,rank", [((2,), 0), ((), RANK), ((2,), RANK)])
def test_nerf_mlp_with_skip_layers_and_lora_matches_jax(skip, rank):
    jm, params = _jax_params(rank=rank, skip=skip)
    pts = RNG.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    dirs = RNG.standard_normal((64, 3)).astype(np.float32)
    w_rgb, w_sigma = jm.apply({"params": params}, jnp.asarray(pts), jnp.asarray(dirs))
    tm = NeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=HIDDEN,
                 num_layers=N_LAYERS, skip_layers=skip, lora_rank=rank, lora_alpha=ALPHA,
                 sigma_bias_init=0.1)
    tm.load_state_dict(nerf_mlp_from_jax(params))
    if skip:  # layer 2 reads [h | x]: 128 + 90 columns
        w = tm.trunk[2].base.weight if rank else tm.trunk[2].weight
        assert w.shape == (HIDDEN, HIDDEN + 90)
    with torch.no_grad():
        g_rgb, g_sigma = tm(_t(pts), _t(dirs))
    np.testing.assert_allclose(g_rgb.numpy(), np.asarray(w_rgb), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(g_sigma.numpy(), np.asarray(w_sigma), rtol=1e-5, atol=2e-5)


def test_lora_dropout_stays_off_unless_asked_for():
    """A module in training mode (torch's default) computes the same as in
    eval mode: the trainer's calls are deterministic, as the JAX trainer's
    ``apply`` without a dropout rng; ``deterministic=False`` turns the
    dropout on."""
    _, params = _jax_params()
    tm = NeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=HIDDEN,
                 num_layers=N_LAYERS, lora_rank=RANK, lora_alpha=ALPHA)
    tm.load_state_dict(nerf_mlp_from_jax(params))
    pts, dirs = _t(RNG.uniform(-1, 1, (32, 3))), _t(RNG.standard_normal((32, 3)))
    assert tm.training
    with torch.no_grad():
        train_mode = tm(pts, dirs)
        eval_mode = tm.eval()(pts, dirs)
        dropped = tm.train()(pts, dirs, deterministic=False)
    assert all(torch.equal(a, b) for a, b in zip(train_mode, eval_mode))
    assert not torch.equal(dropped[1], eval_mode[1])


def test_lora_labels_follow_the_jax_path_filter():
    """``lora`` exactly where the JAX ``lora_label_fn`` labels the leaf of
    the same parameter ``lora``; the heads are ``base``."""
    from nerf_fewshot_tpu.models.lora import lora_label_fn as jax_label_fn

    _, params = _jax_params()
    want = {k: v for k, v in zip(nerf_mlp_from_jax(params),
                                 _jax_labels_in_port_order(jax_label_fn(params)))}
    tm = NeRFMLP(use_viewdirs=True, hidden_dim=HIDDEN, num_layers=N_LAYERS, lora_rank=RANK)
    got = {name: lora_label_fn(name) for name, _ in tm.named_parameters()}
    assert got == want
    assert got["rgb_head.weight"] == got["trunk.0.base.weight"] == "base"
    assert sum(v == "lora" for v in got.values()) == 2 * N_LAYERS


def _jax_labels_in_port_order(labels):
    """The JAX label tree in ``nerf_mlp_from_jax``'s key order (a kernel's
    label stands for its transposed weight)."""
    out = []
    for i in range(N_LAYERS):
        t = labels[f"trunk_{i}"]
        out += [t["base"]["kernel"], t["base"]["bias"], t["lora_a"], t["lora_b"]]
    for head in ("sigma_head", "rgb_head"):
        out += [labels[head]["kernel"], labels[head]["bias"]]
    return out


def test_pack_params_merges_lora_as_jax():
    """``W + (alpha / r) A @ B`` per trunk layer, in the inline-PE layout
    (``row_perm``, padded to D 96)."""
    _, params = _jax_params()
    perm, _, _, x_dim = tk.pe_layout(10, 4, True, 0)
    d_pad = tk.pe_width(x_dim)
    want = jk.pack_params(params, N_LAYERS, HIDDEN, ALPHA, d_pad=d_pad, row_perm=perm)
    got = tk.pack_params(nerf_mlp_from_jax(params), N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm,
                         lora_alpha=ALPHA)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    plain = tk.pack_params(nerf_mlp_from_jax(params), N_LAYERS, HIDDEN, d_pad=d_pad,
                           row_perm=perm, lora_alpha=0.0)
    assert (got[2] - plain[2]).abs().max() > 1e-3  # the update is live
    _, skipped = _jax_params(skip=(2,))
    with pytest.raises(ValueError, match="uniform"):
        tk.pack_params(nerf_mlp_from_jax(skipped), N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm)


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    ro = np.broadcast_to([0.0, 0.0, 4.0], (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    return ro, rd, rng.uniform(0, 1, (R, 3)).astype(np.float32)


@pytest.mark.parametrize("inline_pe", [True, False])
def test_train_objective_with_lora_matches_jax_kernel(inline_pe):
    """Loss, and the gradients of ``base``, ``lora_a``, ``lora_b`` and the
    heads as one vector: the port's autograd through the merge against the
    JAX autodiff through its merge, kernel 1 (or 5) in interpret mode.

    The vector is held to rel 5e-3, the bound ``test_torch_port_train_
    objective.py`` derives for ReLU gates that the two fp32 routes round to
    opposite sides: here a layer-1 pre-activation of the seeded data lies
    6e-8 from zero, and its flip moves the vector by 3.5e-4 (measured; the
    same seed without the LoRA update gives 3e-5). The LoRA pair's own
    gradients are then held, on the port's side, to the chain rule through
    the merge at rtol 1e-5."""
    R, S = 48, 16
    _, params = _jax_params()
    ro, rd, tgt = _rays(R, 6)
    mask = (np.arange(R) < R - 5).astype(np.float32)
    want_loss, want_grads = jax_loss_grad(
        params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), jnp.asarray(mask),
        JaxRenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False), 10, 4, N_LAYERS,
        HIDDEN, lora_alpha=ALPHA, interpret=True, inline_pe=inline_pe)
    got_loss, got = tt.fused_train_loss_grad(
        nerf_mlp_from_jax(params), _t(ro), _t(rd), _t(tgt), _t(mask),
        RenderSettings(near=2.0, far=6.0, n_samples=S), 10, 4, N_LAYERS, HIDDEN,
        inline_pe=inline_pe, lora_alpha=ALPHA)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(got) == set(want)
    g = torch.cat([got[k].reshape(-1).double() for k in want])
    w = torch.cat([want[k].reshape(-1).double() for k in want])
    assert ((g - w).norm() / w.norm()).item() < 5e-3
    assert all(want[f"trunk.{i}.lora_{ab}"].norm() > 0 for i in range(N_LAYERS) for ab in "ab")
    # the merge's chain rule on the port's side: dA = s dW B^T, dB = s A^T dW
    # with dW the gradient of the merged weight, which is the base's
    state, s = nerf_mlp_from_jax(params), ALPHA / RANK
    for i in range(N_LAYERS):
        dw = got[f"trunk.{i}.base.weight"].T
        a, b = state[f"trunk.{i}.lora_a"], state[f"trunk.{i}.lora_b"]
        torch.testing.assert_close(got[f"trunk.{i}.lora_a"], s * dw @ b.T, rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(got[f"trunk.{i}.lora_b"], s * a.T @ dw, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_eval_render_of_a_lora_model_matches_jax(white_bkgd):
    """``fused_render_rays(forward_only=True)``: the merged weights through
    kernel 2 (its plain version here, interpret mode in JAX)."""
    R, S = 24, 16
    _, params = _jax_params(seed=3)
    ro, rd, _ = _rays(R, 7)
    settings = dict(n_samples=S, white_bkgd=white_bkgd)
    want = jfused.fused_render_rays(
        params, jnp.asarray(ro), jnp.asarray(rd), JaxRenderSettings(**settings), pos_freq=10,
        dir_freq=4, num_layers=N_LAYERS, hidden_dim=HIDDEN, lora_alpha=ALPHA, tile_rays=8,
        interpret=True, forward_only=True)
    got = fused_render_rays(
        nerf_mlp_from_jax(params), _t(ro), _t(rd), RenderSettings(**settings), pos_freq=10,
        dir_freq=4, num_layers=N_LAYERS, hidden_dim=HIDDEN, forward_only=True, device="cpu",
        lora_alpha=ALPHA)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4 if name == "depth" else 2e-5, err_msg=name)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("kind,wd,clip", [("adam", 1e-2, 0.5), ("adamw", 1e-2, 0.5),
                                          ("adam", 0.0, 0.0)])
def test_lora_only_optimizer_matches_the_jax_chain(x64, kind, wd, clip):
    """10 steps of the same gradients on a LoRA layer and a head: the JAX
    ``multi_transform`` (the chain on ``lora``, ``set_to_zero`` on ``base``)
    and the port's optimizer over the ``lora`` parameters alone. The clip
    and the decay see the LoRA leaves only; the base leaves never move.

    The learning rate: the JAX ``set_learning_rate`` does not reach the
    rate inside a ``multi_transform`` state (its tuple branch takes the
    state first), so the JAX LoRA-only phase keeps ``cfg.lr`` whatever the
    MultiStep schedule says; the port's reaches it. Both are held at one
    rate here, and the split is pinned at the end (ROADMAP queue 3)."""
    rng = np.random.default_rng(12)
    tree = {"trunk_0": {"base": {"kernel": (6, 5), "bias": (5,)}, "lora_a": (6, 2),
                        "lora_b": (2, 5)}, "rgb_head": {"kernel": (5, 3), "bias": (3,)}}
    paths = {"trunk.0.base.weight": ("trunk_0", "base", "kernel"),
             "trunk.0.base.bias": ("trunk_0", "base", "bias"),
             "trunk.0.lora_a": ("trunk_0", "lora_a"), "trunk.0.lora_b": ("trunk_0", "lora_b"),
             "rgb_head.weight": ("rgb_head", "kernel"), "rgb_head.bias": ("rgb_head", "bias")}

    def get(t, path):
        for p in path:
            t = t[p]
        return t

    shapes = {name: get(tree, path) for name, path in paths.items()}
    p0 = {name: rng.standard_normal(s) for name, s in shapes.items()}
    grads = [{name: rng.standard_normal(s) * (0.02 if i % 3 == 0 else 0.5)
              for name, s in shapes.items()} for i in range(10)]

    def as_tree(flat):
        out = {"trunk_0": {"base": {}}, "rgb_head": {}}
        for name, path in paths.items():
            get(out, path[:-1])[path[-1]] = jnp.asarray(flat[name])
        return out

    ocfg = dict(lr=1e-2, weight_decay=wd, kind=kind, grad_clip=clip)
    jp = as_tree(p0)
    tx = joptim.make_optimizer(jcfg.OptimizerConfig(**ocfg), jp, lora_only=True)
    state = tx.init(jp)
    tp = {name: torch.nn.Parameter(torch.tensor(v)) for name, v in p0.items()}
    opt = toptim.make_optimizer(tcfg.OptimizerConfig(**ocfg), tp.items(), lora_only=True)
    assert [len(g["params"]) for g in opt.param_groups] == [2]
    clipped = 0
    for i, g in enumerate(grads):
        updates, state = tx.update(as_tree(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in tp.items():
            p.grad = torch.tensor(g[name])
        opt.step()
        clipped += int(np.sqrt(sum(np.sum(g[n] ** 2) for n in ("trunk.0.lora_a",
                                                                "trunk.0.lora_b"))) >= clip > 0)
        for name, path in paths.items():
            np.testing.assert_allclose(tp[name].detach().numpy(), np.asarray(get(jp, path)),
                                       rtol=1e-10, atol=1e-13, err_msg=f"{name} step {i}")
    if clip:
        assert 0 < clipped < len(grads)
    for name in paths:
        moved = not np.array_equal(tp[name].detach().numpy(), p0[name])
        assert moved == (lora_label_fn(name) == "lora"), name
    joptim.set_learning_rate(state, 3e-3)
    toptim.set_learning_rate(opt, 3e-3)
    assert float(state.inner_states["lora"].inner_state.hyperparams["learning_rate"]) == 1e-2
    assert opt.param_groups[0]["lr"] == 3e-3


# ------------------------------------------------------------------ trainer

RES = 16


def _config(mod, save_dir="unused", **over):
    d = {
        "experiment": {"name": "port-lora-trunk"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1, "lora_rank": RANK,
                       "lora_alpha": ALPHA},
        # phase 0: 8x8 rays per view in batches of 48; phase 1: 16x16 in 96
        "training": {"epochs": 3, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6, "lora_only_after_epoch": 1},
        "rendering": {"chunk_size": 128},
        "output": {"save_dir": save_dir, "val_freq": 1, "save_freq": 1},
        "seed": 0,
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 1, img_size=RES, gt_samples=32, split="test")
    return train, test


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_two_phase_trainer_matches_the_jax_trainer(scene, monkeypatch, tmp_path, backend):
    """``lora_only_after_epoch: 1``: epoch 0 trains everything, epochs 1 and
    2 the LoRA pairs alone through a fresh optimizer (the JAX trainer on its
    CPU path; the port through the kernels' plain versions, ``auto``, or the
    plain pipeline, ``xla``). After the boundary every base weight and head
    stays bit-equal and every ``lora_b`` moves. A checkpoint saved after the
    freeze does not resume in a fresh trainer on either side (the JAX
    restore fails on the optimizer state's structure), one saved before it
    does."""
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg), train, test)
    ptr = Trainer(_config(tcfg, rendering={"backend": backend}), _port_data(train),
                  _port_data(test), device="cpu")
    assert ptr._use_fused() == (backend == "auto")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}

    np.testing.assert_allclose(ptr.train_epoch(0), jtr.train_epoch(0), rtol=1e-4)
    ptr.epoch = 0
    ptr.save(str(tmp_path / "before.ckpt"))
    before = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    for epoch in (1, 2):
        np.testing.assert_allclose(ptr.train_epoch(epoch), jtr.train_epoch(epoch), rtol=1e-4)
    assert ptr._lora_only_active and jtr._lora_only_active
    assert sum(len(g["params"]) for g in ptr.optimizer.param_groups) == 2 * N_LAYERS
    after = ptr.model.state_dict()
    for k, v in after.items():
        if lora_label_fn(k) == "base":
            assert torch.equal(v, before[k]), k
        elif k.endswith("lora_b"):
            assert not torch.equal(v, before[k]), k

    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    dg = torch.cat([(after[k] - start[k]).reshape(-1) for k in start]).double()
    dw = torch.cat([(want[k] - start[k]).reshape(-1) for k in start]).double()
    assert ((dg - dw).norm() / dw.norm()).item() < 2e-3

    if backend == "auto":
        ptr.epoch = 2
        ptr.save(str(tmp_path / "after.ckpt"))
        jtr.epoch = 2
        jtr.save(str(tmp_path / "after_jax.ckpt"))
        with pytest.raises(ValueError):
            jax_trainer_mod.Trainer(_config(jcfg), train, test).load(
                str(tmp_path / "after_jax.ckpt"))
        fresh = Trainer(_config(tcfg), _port_data(train), device="cpu")
        with pytest.raises(ValueError, match="cannot resume across the freeze"):
            fresh.load(str(tmp_path / "after.ckpt"))
        fresh.load(str(tmp_path / "before.ckpt"))
        assert fresh.epoch == 1
        fresh.train_epoch(1)
        assert fresh._lora_only_active
