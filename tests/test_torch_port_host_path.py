"""The host glue that feeds kernels 1 and 2 (``render/kernels.py``:
``pe_constants``, the gather of ``pack_params``; ``render/train_kernel.py``
and ``render/fused.py``; ``Trainer.epoch_steps`` / ``render_views``), held
bit for bit against what it replaced and against the JAX package's
``pe_layout`` and ``pack_params``.

The glue only moves data: the layout constants are made once per device,
a trunk without LoRA is packed by one cached gather (and its gradients by
one gather back), an eval call packs its weights once for every chunk, and
the batch indices reach a card by a stream-ordered copy. None of it may
change a number, so every comparison here is of bits (``_bits``: the
sign of a zero counts), not within a tolerance. On the card the same
code is held to making no stream synchronization inside an epoch or an
eval call (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``'s train
step breakdown).
"""

import numpy as np
import pytest
import torch

from nerf_fewshot_tpu.render import kernels as jk
from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import fused as tf
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import optim as toptim
from nerf_fewshot_tpu_torch.training import trainer as trainer_mod
from nerf_fewshot_tpu_torch.training.config import config_from_dict
from nerf_fewshot_tpu_torch.training.trainer import Trainer

HIDDEN, N_LAYERS = 128, 3
RES = 16


def _bits(t: torch.Tensor) -> np.ndarray:
    """The bit pattern of a float tensor (-0.0 apart from +0.0)."""
    a = t.detach().contiguous().numpy()
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _same(got, want, label="", strides=False):
    """Bit-equal tensors of the same shapes (and, with ``strides``, the same
    memory layouts: a reduction over a gradient sums in layout order)."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), (label, i, g.shape, w.shape)
        assert np.array_equal(_bits(g), _bits(w)), (label, i)
        assert not strides or g.stride() == w.stride(), (label, i, g.stride(), w.stride())


# ------------------------------------------------------------ pe_constants

LAYOUTS = {"baseline": (10, 4, True, 0), "dino_single": (12, 4, True, 64),
           "dino_multi": (12, 4, True, 128), "no_viewdirs": (10, 4, False, 0)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pe_constants_are_pe_layout_made_once(layout):
    """``pe_constants`` holds ``pe_layout``'s arrays (and the JAX package's)
    as tensors, int64 and fp32, and a second call returns the same tensors."""
    pos, dirs, viewdirs, fd = LAYOUTS[layout]
    consts = tk.pe_constants(pos, dirs, viewdirs, fd, "cpu")
    perm, e2, c, x_dim = tk.pe_layout(pos, dirs, viewdirs, fd)
    jperm, je2, jc, jx_dim = jk.pe_layout(pos, dirs, viewdirs, fd)
    assert consts.row_perm.dtype == torch.int64
    assert consts.e2.dtype == consts.c.dtype == torch.float32
    assert consts.x_dim == x_dim == jx_dim
    for got, want, jwant in ((consts.row_perm, perm, jperm), (consts.e2, e2, je2),
                             (consts.c, c, jc)):
        assert np.array_equal(got.numpy(), want) and np.array_equal(want, np.asarray(jwant))
        assert got.numpy().dtype == want.dtype
    again = tk.pe_constants(pos, dirs, viewdirs, fd, torch.device("cpu"))
    assert all(a is b for a, b in zip(again, consts))


def test_to_device_copies_off_the_card():
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = tk.to_device(a, torch.device("cpu"))
    a[0, 0] = 7
    assert t.dtype == torch.int64 and t.tolist() == [[0, 1, 2], [3, 4, 5]]


# ------------------------------------------------------------ pack_params

def _model(lora_rank=0, feat_dim=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, dino_dim=feat_dim, hidden_dim=HIDDEN,
                num_layers=N_LAYERS, lora_rank=lora_rank, sigma_bias_init=0.1, generator=g)
    if lora_rank:  # a live update: lora_b starts at zero
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("lora_b"):
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return m


def _cotangents(packed, seed):
    """Standard-normal cotangents with a third of them -0.0, which the row
    gather's backward turns into +0.0."""
    g = torch.Generator().manual_seed(seed)
    cots = []
    for p in packed:
        ct = torch.randn(p.shape, generator=g)
        ct[ct.abs() < 0.45] = -0.0
        cots.append(ct)
    return cots


@pytest.mark.parametrize("case", ["perm_tensor", "perm_sequence", "no_perm", "features",
                                  "lora_perm_tensor"])
def test_pack_params_is_bit_equal_to_the_layer_by_layer_packing(case):
    """The gather (a trunk without LoRA) against the per-layer transposes,
    stacks, concatenations and row gather it replaces (``_pack_merged``),
    forward and autograd gradients (their strides too), the sign of each
    zero included; a LoRA
    trunk keeps the per-layer path, its row gather now from
    ``pe_constants``' tensor."""
    lora = 4 if case.startswith("lora") else 0
    fd = 64 if case == "features" else 0
    model = _model(lora, fd)
    params = dict(model.named_parameters())
    consts = tk.pe_constants(10, 4, True, fd, "cpu")
    perm = {"perm_sequence": list(consts.row_perm.tolist()), "no_perm": None}.get(
        case, consts.row_perm)
    d_pad = tk.D_PAD if perm is None else tk.pe_width(consts.x_dim)
    got = tk.pack_params(params, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm)
    old_perm = None if perm is None else np.asarray(consts.row_perm.tolist())
    want = tk._pack_merged(params, N_LAYERS, HIDDEN, d_pad, old_perm, 16.0)
    _same(got, want, "packed")
    assert all(p.is_contiguous() for p in got)
    cots = _cotangents(got, 1)
    names = list(params)
    g_got = torch.autograd.grad(got, [params[k] for k in names], cots)
    g_want = torch.autograd.grad(want, [params[k] for k in names], cots)
    _same(g_got, g_want, "gradients", strides=True)
    if lora:
        with pytest.raises(ValueError, match="LoRA"):
            tk.packed_grads(params, N_LAYERS, HIDDEN, d_pad, perm, cots)
    else:  # the same gradients without the autograd engine
        direct = tk.packed_grads(params, N_LAYERS, HIDDEN, d_pad, perm, cots)
        assert sorted(direct) == sorted(names)
        _same([direct[k] for k in names], g_want, "packed_grads", strides=True)
    if perm is not None:  # the +0.0 of the row gather's backward is kept
        w0 = g_got[names.index("trunk.0.weight" if not lora else "trunk.0.base.weight")]
        assert not torch.any(torch.signbit(w0) & (w0 == 0))
    with torch.no_grad():
        _same(tk.pack_params(params, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=perm), want,
              "no_grad")


def test_pack_params_gather_is_the_jax_pack():
    """The gather's packed tensors are the JAX ``pack_params``' bit for bit
    (both only move data) on the same seeded params, with the inline-PE
    row permutation."""
    import jax
    import jax.numpy as jnp

    from nerf_fewshot_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=HIDDEN,
                    num_layers=N_LAYERS, sigma_bias_init=0.1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(3), jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"])
    perm, _, _, x_dim = jk.pe_layout(10, 4, True, 0)
    want = jk.pack_params(params, N_LAYERS, HIDDEN, d_pad=tk.pe_width(x_dim), row_perm=perm)
    consts = tk.pe_constants(10, 4, True, 0, "cpu")
    got = tk.pack_params(nerf_mlp_from_jax(params), N_LAYERS, HIDDEN,
                         d_pad=tk.pe_width(consts.x_dim), row_perm=consts.row_perm)
    _same(got, [torch.from_numpy(np.array(w)) for w in want])


@pytest.mark.parametrize("bad", ["repeat", "range"])
def test_a_row_perm_that_is_no_permutation_is_packed_layer_by_layer(bad):
    """A repeated row packs as before (the row gather's backward sums both
    rows' cotangents); a row out of range raises as before."""
    params = dict(_model().named_parameters())
    perm = tk.pe_layout(10, 4, True, 0)[0].copy()
    perm[1] = perm[0] if bad == "repeat" else 10 ** 6
    if bad == "range":
        with pytest.raises(IndexError):
            tk.pack_params(params, N_LAYERS, HIDDEN, d_pad=96, row_perm=perm)
        return
    got = tk.pack_params(params, N_LAYERS, HIDDEN, d_pad=96, row_perm=perm)
    want = tk._pack_merged(params, N_LAYERS, HIDDEN, 96, perm, 16.0)
    _same(got, want)
    cots = _cotangents(got, 2)
    _same(torch.autograd.grad(got, list(params.values()), cots),
          torch.autograd.grad(want, list(params.values()), cots), strides=True)
    with pytest.raises(ValueError, match="permutation"):
        tk.packed_grads(params, N_LAYERS, HIDDEN, 96, perm, cots)


# ------------------------------------------------------------ the clip

@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm_is_stream_ordered_and_bit_equal(max_norm):
    """Below the limit every gradient keeps its bits; above it each is
    ``g / ||g|| * max_norm`` in that order (optax's rule), as the host-side
    branch gave."""
    g = torch.Generator().manual_seed(2)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in ((7, 5), (3,), (2, 2, 2))]
    for p in params:
        p.grad = torch.randn(p.shape, generator=g)
    before = [p.grad.clone() for p in params]
    norm = torch.sqrt(sum(torch.sum(b * b) for b in before))
    want = before if bool(norm < max_norm) else [b.div(norm).mul(max_norm) for b in before]
    toptim.clip_by_global_norm_(params, max_norm)
    _same([p.grad for p in params], want)
    assert (max_norm < 1.0) == (not all(torch.equal(a, b) for a, b in zip(before, want)))


# ------------------------------------------------------------ the trainer

def _config(kind):
    d = {
        "experiment": {"name": "port-host-path"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        # phase 0: 8x8 rays per view in batches of 48 (ragged tail of 32);
        # phase 1: 16x16 in batches of 96 (ragged tail of 32)
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 96},
        "seed": 0,
    }
    if kind == "hierarchical":
        d["rendering"]["n_importance"] = 6
    if kind == "lora":
        d["nerf_model"]["lora_rank"] = 4
    if kind == "dino":
        d["model"] = {"use_dino": True, "dino_model_type": "single_scale"}
        d["nerf_model"]["pos_freq"] = 12
    if kind == "clip":
        d["optimizer"]["grad_clip"] = 0.05
    return config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = make_scene_dataset(lego_like_scene(), 2, img_size=RES, gt_samples=32, device="cpu")
    test = make_scene_dataset(lego_like_scene(), 2, img_size=RES, gt_samples=32, split="test",
                              device="cpu")
    return train, test


def _trainer(kind, scene):
    train, test = scene
    feats = None
    if kind == "dino":
        feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    tr = Trainer(_config(kind), train, test, device="cpu", dino_features=feats)
    assert tr._use_fused() and tr.kernel_path == "kernel"
    return tr


def _per_step_glue(monkeypatch):
    """The glue as it was: the layout constants made from ``pe_layout`` at
    every call (fresh tensors the pack cannot recognise), the weights
    packed layer by layer from a host permutation and the gradients taken
    through the packing by autograd."""

    def fresh_constants(pos, dirs, viewdirs, fd, device):
        perm, e2, c, x_dim = tk.pe_layout(pos, dirs, viewdirs, fd)
        return tk.PEConstants(torch.as_tensor(perm, device=device),
                              torch.as_tensor(e2, device=device),
                              torch.as_tensor(c, device=device), x_dim)

    def layer_by_layer(state, num_layers, hidden_dim, d_pad=tk.D_PAD, row_perm=None,
                       lora_alpha=16.0, **_):
        if isinstance(row_perm, torch.Tensor):
            row_perm = row_perm.tolist()
        return tk._pack_merged(state, num_layers, hidden_dim, d_pad, row_perm, lora_alpha)

    def by_autograd(params, num_layers, hidden_dim, row_perm, lora_alpha, dpacked, out):
        names = list(params)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            packed = layer_by_layer(leaves, num_layers, hidden_dim, dpacked[0].shape[0],
                                    row_perm, lora_alpha)
            grads = torch.autograd.grad(packed, [leaves[k] for k in names], list(dpacked))
        if out is not None:
            torch._foreach_copy_(tt._views_of(out, [params[k] for k in names]), list(grads))
        return dict(zip(names, grads))

    for mod in (tt, tf, trainer_mod):
        monkeypatch.setattr(mod, "pe_constants", fresh_constants, raising=False)
        monkeypatch.setattr(mod, "pack_params", layer_by_layer, raising=False)
    monkeypatch.setattr(tt, "_pack_vjp", by_autograd)
    monkeypatch.setattr(tt, "_grad_names", lambda params, num_layers: list(params))


@pytest.mark.parametrize("kind", ["baseline", "hierarchical", "lora", "dino", "clip"])
def test_train_epoch_is_bit_equal_to_constants_built_per_step(kind, scene, monkeypatch):
    """Two epochs (one per phase, jitter on, ragged tails) of the kernel
    path on the CPU: per-step losses and every parameter bit-equal to the
    same epochs with the constants built, the weights packed layer by
    layer and the gradients taken by autograd in every step; ``train_epoch``
    is ``epoch_steps`` and one copy."""
    new = _trainer(kind, scene)
    got = [new.train_epoch(e) for e in (0, 1)]
    got_steps = new.last_step_losses
    extra = new.epoch_steps(1)
    assert extra.shape == (len(got_steps),) and extra.dtype == torch.float32
    with monkeypatch.context() as m:
        _per_step_glue(m)
        old = _trainer(kind, scene)
        want = [old.train_epoch(e) for e in (0, 1)]
        want_steps = old.last_step_losses
        old.epoch_steps(1)
    assert got == want
    assert np.array_equal(got_steps.view(np.int32), want_steps.view(np.int32))
    names = list(dict(old.model.named_parameters()))
    _same([new.model.state_dict()[k] for k in names], [old.model.state_dict()[k] for k in names])


@pytest.mark.parametrize("kind", ["baseline", "hierarchical", "dino"])
def test_render_views_packs_once_and_is_bit_equal_to_packing_per_chunk(kind, scene,
                                                                        monkeypatch):
    """An eval call on the CPU kernel path packs the weights once for its
    chunks (three views at 16x16, 96-ray chunks: 8 chunks, the last padded)
    and renders bit-equal to packing in every chunk (and pass); the host
    arrays are ``render_views_device``'s tensors."""
    tr = _trainer(kind, scene)
    tr.train_epoch(0)
    poses = [np.asarray(p) for p in scene[1].poses] + [np.asarray(scene[0].poses[0])]
    calls = []
    orig = trainer_mod.pack_params
    monkeypatch.setattr(trainer_mod, "pack_params",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    per_chunk = []
    orig_fused = tf.pack_params
    monkeypatch.setattr(tf, "pack_params",
                        lambda *a, **k: per_chunk.append(1) or orig_fused(*a, **k))
    got = tr.render_views(poses)
    assert len(calls) == 1 and not per_chunk
    on_device = tr.render_views_device(poses)
    _same([torch.from_numpy(g) for g in got], on_device, "host copy")

    monkeypatch.setattr(tr, "_ray_render_fn", lambda settings, forward_only=False, pf=None: (
        lambda ro, rd: tf.fused_render_rays(
            tr.model.state_dict(), ro, rd, settings, 10 if kind != "dino" else 12, 4, N_LAYERS,
            HIDDEN, forward_only=True, device="cpu", point_features_fn=pf)))
    want = tr.render_views(poses)
    n_passes = 2 if kind == "hierarchical" else 1
    assert len(per_chunk) == n_passes * -(-len(poses) * RES * RES // 96)
    _same([torch.from_numpy(g) for g in got], [torch.from_numpy(w) for w in want], "views")


def test_fused_render_rays_takes_packed_weights_only_forward():
    state = _model().state_dict()
    ro, rd = torch.zeros(4, 3), torch.ones(4, 3)
    consts = tk.pe_constants(10, 4, True, 0, "cpu")
    packed = tk.pack_params(state, N_LAYERS, HIDDEN, d_pad=tk.pe_width(consts.x_dim),
                            row_perm=consts.row_perm)
    s = RenderSettings(n_samples=4)
    a = tf.fused_render_rays(state, ro, rd, s, 10, 4, N_LAYERS, HIDDEN, forward_only=True,
                             device="cpu", packed=packed)
    b = tf.fused_render_rays(state, ro, rd, s, 10, 4, N_LAYERS, HIDDEN, forward_only=True,
                             device="cpu")
    _same(list(a), list(b))
    with pytest.raises(ValueError, match="forward_only"):
        tf.fused_render_rays(state, ro, rd, s, 10, 4, N_LAYERS, HIDDEN, device="cpu",
                             packed=packed)


def test_encoded_width_is_encode_points_width():
    for pos, dirs, viewdirs, fd in ((10, 4, True, 0), (10, 4, False, 0), (10, 4, True, 768),
                                    (12, 4, True, 64)):
        pts, rd = torch.zeros(2, 3, 3), torch.ones(2, 3)
        feats = torch.zeros(6, fd) if fd else None
        x = tf.encode_points(pts, rd, pos, dirs, viewdirs, feats)
        assert tf.encoded_width(pos, dirs, viewdirs, fd) == x.shape[1]
