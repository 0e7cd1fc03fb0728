"""The LoRA trunk's packing and its VJP (``render/lora_pack.py``,
``csrc/lora_pack.cu``) against the JAX package and against the autograd
branch they replace.

On the CPU, on the same seeded numpy state (a JAX LoRA param tree and the
port's state dict through ``nerf_mlp_from_jax``) at L 3, H 128, ranks 2 and
4, with and without the inline-PE ``row_perm``, d_pad 96 > the 90 input
rows, and at rank 1024 (L 2), at 33 layers (rank 2) and at 1 layer:
``lora_pack_reference`` against the JAX ``pack_params`` (rel 1e-6: the
r-term merge summed in another order; the rest only moves data) and
``lora_pack_vjp_reference`` against ``jax.vjp`` over it (rel 1e-5: the two
reductions in other orders); ``fused_train_loss_grad`` of a LoRA trunk
(``lora_nerf_trunk.yaml``'s widths cut to 3 layers) bit for bit against the
autograd branch it replaced (``_TrainObjective`` and ``torch.autograd.grad``
through the packing), and within rel 1e-4 of the plain pipeline's autograd;
the kernel route refusing a CPU state at any rank and depth; the launches
a deep trunk takes; a trainer at 40 layers and rank 1024 on the kernel
path.

Marked ``cuda`` (skipped here; on the card, without the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_port_lora_pack.py``):
both kernels against their plain versions at ``lora_nerf_trunk.yaml``'s
D 160 / H 256 / rank 4, ``script_lora.yaml``'s D 832, H 512 and 1024, 16,
33 and 64 layers, 33 layers at rank 1024, and at ranks 1 to 2048: up to
rank 1020 the packed weights bit-equal to the plain packing; above it
(where the kernel sums in float64, and torch's sum on the card splits
across blocks) each packed tensor within rel 1e-6 of it and no further
from a float64 packing than it; the base, bias and head gradients
bit-equal, ``lora_a`` and ``lora_b`` within rel 1e-6 of autograd and each
no further from a float64 run than autograd's, a second call bit-equal,
each kernel ceil(L / 32) launches a call; a kernel-path LoRA step (also at
rank 1024 and at 40 layers) launching each ceil(L / 32) times and never
entering the autograd engine. JAX is imported inside the CPU tests alone:
the card machine has none.
"""

import numpy as np
import pytest
import torch

from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import lora_pack as lp
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

HIDDEN, N_LAYERS, ALPHA = 128, 3, 16.0
IN_DIM, D_PAD = 90, 96  # pos_freq 10 and view directions: 63 + 27 input rows


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().cpu().numpy().view(np.int32)


def _same(got, want, label=""):
    """Bit-equal tensors (-0.0 apart from +0.0)."""
    assert tuple(got.shape) == tuple(want.shape), (label, got.shape, want.shape)
    assert np.array_equal(_bits(got), _bits(want)), label


def _jax_tree(rng, in_dim, H, L, rank):
    """A JAX ``NeRFMLP`` LoRA param tree of numpy leaves: torch-default-
    bounded kernels and biases, ``lora_a`` bounded alike, ``lora_b`` live
    (``N(0, 0.05^2)``; it starts at zero in a model)."""
    u = lambda shape, fan: rng.uniform(-1, 1, shape).astype(np.float32) / np.float32(fan ** 0.5)
    tree = {}
    for i in range(L):
        fan = in_dim if i == 0 else H
        tree[f"trunk_{i}"] = {"base": {"kernel": u((fan, H), fan), "bias": u((H,), fan)},
                              "lora_a": u((fan, rank), fan),
                              "lora_b": (0.05 * rng.standard_normal((rank, H))).astype(np.float32)}
    tree["rgb_head"] = {"kernel": u((H, 3), H), "bias": u((3,), H)}
    tree["sigma_head"] = {"kernel": u((H, 1), H), "bias": np.full((1,), 0.1, np.float32)}
    return tree


def _cotangents(shapes, seed, device="cpu"):
    """Standard-normal packed cotangents with a third of them -0.0."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in shapes:
        c = torch.randn(s, generator=g)
        c[c.abs() < 0.45] = -0.0
        out.append(c.to(device))
    return out


def _rel(got, want) -> float:
    """``||got - want|| / ||want||`` over every tensor of the two lists."""
    d = sum(float(torch.sum((g.double() - w.double()) ** 2)) for g, w in zip(got, want))
    n = sum(float(torch.sum(w.double() ** 2)) for w in want)
    return (d / n) ** 0.5 if n else d ** 0.5


# ------------------------------------------------------------ the CPU: against JAX

# (rank, row_perm, layers): the shapes of L 3, then a rank past the card's
# 1020, a trunk past one launch's 32 layers and a trunk of one
CASES = [(2, True, N_LAYERS), (2, False, N_LAYERS), (4, True, N_LAYERS), (4, False, N_LAYERS),
         (1024, True, 2), (2, True, 33), (3, False, 1)]
CASE_IDS = [f"{r}-{p}" if L == N_LAYERS else f"{r}-{p}-L{L}" for r, p, L in CASES]


def _jax_case(rank, perm, seed=7, layers=N_LAYERS):
    from nerf_fewshot_tpu.render import kernels as jk

    tree = _jax_tree(np.random.default_rng(seed + rank), IN_DIM, HIDDEN, layers, rank)
    row_perm = jk.pe_layout(10, 4, True, 0)[0] if perm else None
    return tree, row_perm


@pytest.mark.parametrize("rank,perm,layers", CASES, ids=CASE_IDS)
def test_lora_pack_reference_is_the_jax_pack(rank, perm, layers):
    """The plain packing against the JAX ``pack_params`` of the same numpy
    state: the heads, biases and pads bit-equal (data movement), the merged
    weights within rel 1e-6."""
    import jax
    from nerf_fewshot_tpu.render import kernels as jk

    tree, row_perm = _jax_case(rank, perm, layers=layers)
    want = jax.jit(lambda p: jk.pack_params(p, layers, HIDDEN, ALPHA, D_PAD, row_perm))(tree)
    got = lp.lora_pack_reference(nerf_mlp_from_jax(tree), layers, HIDDEN, D_PAD, row_perm,
                                 ALPHA)
    assert len(got) == 6
    for k, (g, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(w))
        assert tuple(g.shape) == tuple(w.shape) == lp.packed_shapes(layers, HIDDEN, D_PAD)[k]
        if k in (0, 2):
            assert _rel([g], [w]) <= 1e-6, k
        else:
            _same(g, w, f"packed {k}")


@pytest.mark.parametrize("rank,perm,layers", CASES, ids=CASE_IDS)
def test_lora_pack_vjp_reference_is_the_jax_vjp(rank, perm, layers):
    """The plain VJP against ``jax.vjp`` over the JAX ``pack_params`` with the
    same cotangents, every parameter within rel 1e-5, under its port name."""
    import jax
    from nerf_fewshot_tpu.render import kernels as jk

    tree, row_perm = _jax_case(rank, perm, layers=layers)
    cots = _cotangents(lp.packed_shapes(layers, HIDDEN, D_PAD), 11 + rank)

    def vjp(p, c):
        return jax.vjp(lambda q: jk.pack_params(q, layers, HIDDEN, ALPHA, D_PAD, row_perm),
                       p)[1](c)[0]

    want = nerf_mlp_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(vjp)(tree, tuple(c.numpy() for c in cots))))
    state = nerf_mlp_from_jax(tree)
    got = lp.lora_pack_vjp_reference(state, tuple(cots), layers, HIDDEN, row_perm, ALPHA)
    assert list(got) == list(state)
    for name in state:
        assert tuple(got[name].shape) == tuple(state[name].shape), name
        assert _rel([got[name]], [want[name]]) <= 1e-5, name


# ------------------------------------------------------------ the CPU: the trainer's branch

class _OldTrainObjective(torch.autograd.Function):
    """The autograd branch ``fused_train_loss_grad`` took for a LoRA trunk:
    the objective as a function of the packed tensors, its backward the
    kernel's packed gradients times the cotangent."""

    @staticmethod
    def forward(ctx, raw_or_x, feats, z, dnorm, tgt, mask, inv_denom, e2, c, opts, *packed):
        loss, dpacked = tt.fused_train_objective(raw_or_x, feats, z, dnorm, tgt, mask, inv_denom,
                                                 e2, c, tuple(p.detach() for p in packed), **opts)
        ctx.save_for_backward(*dpacked)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        return (None,) * 10 + tuple(torch._foreach_mul(list(ctx.saved_tensors), grad_out))


def _trunk_step_inputs(seed=3, R=24, S=8, layers=N_LAYERS, rank=4):
    """``lora_nerf_trunk.yaml``'s widths cut to 3 layers (H 256, rank 4,
    alpha 16, view directions, 64 features per point; or ``layers`` at
    ``rank``), seeded rays and targets, jitter and a features function of
    the points."""
    rng = np.random.default_rng(seed)
    tree = _jax_tree(rng, IN_DIM + 64, 256, layers, rank)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ro = t(rng.uniform(-0.5, 0.5, (R, 3)) + np.array([0.0, 0.0, 4.0]))
    rd = t(rng.standard_normal((R, 3)) * 0.2 + np.array([0.0, 0.0, -1.0]))
    tgt, uni = t(rng.uniform(0, 1, (R, 3))), t(rng.uniform(0, 1, (R, S)))
    mask = torch.ones(R)
    mask[-3:] = 0.0
    proj = t(rng.standard_normal((3, 64)))
    feats = lambda pts: torch.sin(pts @ proj)
    settings = RenderSettings(n_samples=S, perturb=True, near=2.0, far=6.0)
    return nerf_mlp_from_jax(tree), (ro, rd, tgt, mask, settings, 10, 4, layers, 256), dict(
        uniforms=uni, point_features_fn=feats, reg_weight=0.01, lora_alpha=ALPHA)


def test_lora_trunk_branch_is_bit_equal_to_the_autograd_branch():
    """``fused_train_loss_grad`` of a LoRA trunk on the CPU (the objective,
    then ``lora_pack_vjp`` into the gradient buffer, no autograd engine
    around them) against the branch it replaced, run here as it was: the
    loss and every gradient bit for bit, the buffer holding them in the
    state's order."""
    state, args, kw = _trunk_step_inputs()
    params = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    inputs, opts = tt.train_objective_inputs(params, *args, **kw)
    *inputs, packed = inputs
    loss = _OldTrainObjective.apply(*inputs, opts, *packed)
    want = torch.autograd.grad(loss, list(params.values()))

    buf, views = tt.grad_buffer(state, N_LAYERS)
    got_loss, got = tt.fused_train_loss_grad(state, *args, grad_buffer=buf, **kw)
    _same(got_loss, loss.detach(), "loss")
    assert list(got) == list(state)
    for name, w in zip(state, want):
        _same(got[name], w, name)
        _same(views[name], w, f"buffer {name}")


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_lora_trunk_gradient_reaches_the_module_as_the_plain_pipeline(lora_rank):
    """A ``NeRFMLP`` passed as a module, with trunk LoRA (``lora_b`` live)
    or without: the kernel path's gradients, by name, within rel 1e-4 of the
    plain pipeline's autograd (cos against sin(+pi/2), sums in other
    orders)."""
    from nerf_fewshot_tpu_torch.render.pipeline import render_rays

    g = torch.Generator().manual_seed(4)
    model = NeRFMLP(10, 4, True, hidden_dim=HIDDEN, num_layers=N_LAYERS, lora_rank=lora_rank,
                    sigma_bias_init=0.1, generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(9)
    R = 16
    ro, rd, tgt = (torch.from_numpy(rng.standard_normal((R, 3)).astype(np.float32))
                   for _ in range(3))
    settings = RenderSettings(n_samples=8)
    _, grads = tt.fused_train_loss_grad(model, ro, rd, tgt, torch.ones(R), settings, 10, 4,
                                        N_LAYERS, HIDDEN, lora_alpha=16.0)
    assert all(p.grad is None for p in model.parameters())
    out = render_rays(model, ro, rd, settings)
    torch.mean((out.rgb - tgt) ** 2).backward()
    names = [n for n, _ in model.named_parameters()]
    assert _rel([grads[n] for n in names], [p.grad for p in model.parameters()]) < 1e-4


def test_lora_pack_out_and_plain_route():
    """``out=`` on the plain route: the six tensors are the buffer's views,
    bit-equal to the reference; ``lora_pack_vjp(out=)`` fills the buffer in
    the state's order; ``pack_params`` sends a LoRA trunk to ``lora_pack``."""
    tree, row_perm = _jax_case(4, True)
    state = nerf_mlp_from_jax(tree)
    want = lp.lora_pack_reference(state, N_LAYERS, HIDDEN, D_PAD, row_perm, ALPHA)
    buf = lp.pack_buffer(N_LAYERS, HIDDEN, D_PAD, "cpu")
    got = lp.lora_pack(state, N_LAYERS, HIDDEN, D_PAD, row_perm, ALPHA, out=buf, plain=True)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.data_ptr() >= buf.data_ptr() and g.is_contiguous()
        _same(g, w, f"packed {k}")
    for k, (g, w) in enumerate(zip(tk.pack_params(state, N_LAYERS, HIDDEN, D_PAD, row_perm,
                                                  ALPHA), want)):
        _same(g, w, f"pack_params {k}")
    cots = tuple(_cotangents([w.shape for w in want], 5))
    out = torch.full((sum(v.numel() for v in state.values()),), float("nan"))
    grads = lp.lora_pack_vjp(state, cots, N_LAYERS, HIDDEN, row_perm, ALPHA, out=out, plain=True)
    _same(out, torch.cat([grads[k].reshape(-1) for k in state]), "vjp buffer")


def test_the_kernel_route_needs_a_card():
    """Without ``plain`` a CPU state raises in both wrappers, and so does a
    trunk without LoRA. A rank above 1020 and a trunk deeper than one
    launch's 32 layers are no longer refused: on the CPU they raise as any
    CPU state does."""
    tree, row_perm = _jax_case(2, True)
    state = nerf_mlp_from_jax(tree)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lp.lora_pack(state, N_LAYERS, HIDDEN, D_PAD, row_perm, ALPHA)
    cots = tuple(_cotangents(lp.packed_shapes(N_LAYERS, HIDDEN, D_PAD), 1))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lp.lora_pack_vjp(state, cots, N_LAYERS, HIDDEN, row_perm, ALPHA)
    plain = {k: v for k, v in state.items() if "lora" not in k}
    with pytest.raises(ValueError, match="not a 3-layer LoRA trunk"):
        lp.lora_pack(plain, N_LAYERS, HIDDEN, D_PAD, row_perm, ALPHA)
    for rank, layers in ((1021, 1), (2, 33)):
        big = nerf_mlp_from_jax(_jax_tree(np.random.default_rng(0), 8, HIDDEN, layers, rank))
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            lp.lora_pack(big, layers, HIDDEN, 128)
        cots = tuple(_cotangents(lp.packed_shapes(layers, HIDDEN, 128), 2))
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            lp.lora_pack_vjp(big, cots, layers, HIDDEN)
    assert lp.is_lora_trunk(state, N_LAYERS) and not lp.is_lora_trunk(plain, N_LAYERS)
    assert lp.lora_pack.launches == 0 and lp.lora_pack_vjp.launches == 0


def test_a_deep_trunk_takes_a_launch_per_32_layers():
    """``launch_layers``: each launch's first layer and count, at most
    ``LAYERS_PER_LAUNCH`` (the size of ``csrc/lora_pack.cu``'s pointer
    table, ``kMaxLayers``), covering every layer once; the wrapper's
    constants are the kernel source's, and no rank or depth cap is left in
    either."""
    import os
    import re

    assert lp.launch_layers(1) == [(0, 1)]
    assert lp.launch_layers(32) == [(0, 32)]
    assert lp.launch_layers(40) == [(0, 32), (32, 8)]
    assert lp.launch_layers(65) == [(0, 32), (32, 32), (64, 1)]
    for L in range(1, 100):
        spans = lp.launch_layers(L)
        assert len(spans) == -(-L // lp.LAYERS_PER_LAUNCH)
        assert [i for f, n in spans for i in range(f, f + n)] == list(range(L))
    src = open(os.path.join(os.path.dirname(lp.__file__), "..", "csrc", "lora_pack.cu")).read()
    assert int(re.search(r"kMaxLayers = (\d+);", src).group(1)) == lp.LAYERS_PER_LAUNCH
    assert int(re.search(r"kTorchOrderRank = (\d+);", src).group(1)) == lp.TORCH_ORDER_RANK
    assert "kMaxRank" not in src and "max_layers" not in src
    assert not hasattr(lp, "MAX_RANK") and not hasattr(lp, "MAX_LAYERS")


def test_a_deep_high_rank_lora_trainer_takes_the_kernel_path():
    """A trainer at 40 layers and LoRA rank 1024 (past the caps the LoRA pack
    kernels once had) takes the kernel path with no reason recorded, on the
    CPU (the kernels' plain versions) and as the choice a card makes."""
    from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict({
        "data": {"resolution": 8, "num_views": 1},
        "nerf_model": {"hidden_dim": HIDDEN, "num_layers": 40, "lora_rank": 1024,
                       "lora_alpha": ALPHA, "sigma_bias": 0.1},
        "training": {"phases": [{"start": 0, "H": 8, "n_samples": 8, "batch_size": 16}]},
        "seed": 0})
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    data = BlenderDataset(np.zeros((1, 8, 8, 3), np.float32), pose[None], 8, 8, 8.0)
    tr = Trainer(cfg, data, device="cpu")
    assert tr.model.trunk[39].lora_a.shape == (HIDDEN, 1024)
    assert tr._use_fused() and (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)
    tr.device = torch.device("cuda", 0)
    assert tr._use_fused() and (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)


# ------------------------------------------------------------ the card

@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip(f"{torch.cuda.get_device_name(0)} is not sm_90")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (label, input rows, H, layers, rank, with row_perm, zero lora_b)
CARD_CASES = [("lora_nerf_trunk D 160", 154, 256, 8, 4, True, False),
              ("lora_nerf_trunk at init", 154, 256, 8, 4, True, True),
              ("script_lora D 832", 831, 256, 8, 4, True, False),
              ("H 512", 154, 512, 8, 4, True, False),
              ("H 1024", 154, 1024, 8, 4, False, False),
              ("16 layers", 90, 256, 16, 4, True, False),
              ("33 layers", 154, 256, 33, 4, True, False),
              ("64 layers", 90, 128, 64, 4, True, False),
              ("33 layers rank 1024", 90, 128, 33, 1024, True, False)]
# up to 1020 torch's order on the card, from 1021 the kernel's float64 sums
RANKS = [1, 2, 3, 5, 8, 16, 63, 64, 100, 256, 512, 1020, 1021, 1023, 1024, 2048]


def card_case(device, in_dim, H, L, rank, perm, zero_b, seed=0, signed_zeros=True):
    """A seeded LoRA trunk on ``device`` (the state in the model's order),
    its ``row_perm`` (a seeded permutation, or None) and ``d_pad``; with
    ``signed_zeros`` some base weights and ``lora_a`` entries are -0.0 or
    +0.0, the merge's zero cases."""
    rng = np.random.default_rng(seed)
    tree = _jax_tree(rng, in_dim, H, L, rank)
    if zero_b:
        for i in range(L):
            tree[f"trunk_{i}"]["lora_b"][:] = 0.0
    if signed_zeros:
        for i in range(L):
            layer = tree[f"trunk_{i}"]
            layer["base"]["kernel"][:3, :5] = -0.0
            layer["lora_a"][1, :] = 0.0
            layer["lora_a"][2, :] = -0.0
    jax_state = nerf_mlp_from_jax(tree)
    names = [f"trunk.{i}.{p}" for i in range(L) for p in ("lora_a", "lora_b", "base.weight",
                                                          "base.bias")]
    names += ["sigma_head.weight", "sigma_head.bias", "rgb_head.weight", "rgb_head.bias"]
    state = {n: jax_state[n].to(device).contiguous() for n in names}  # the model's order
    row_perm = None
    if perm:
        row_perm = torch.from_numpy(rng.permutation(in_dim).astype(np.int64)).to(device)
    return state, row_perm, tk.pe_width(in_dim)


def check_card_case(state, row_perm, d_pad, L, H, seed=1):
    """Both kernels against their plain versions, as the module's docstring
    says; returns ``(max rel of lora_a / lora_b to autograd, the largest
    excess of a LoRA tensor's f64 distance over autograd's)``."""
    launches = -(-L // 32)
    before = (lp.lora_pack.launches, lp.lora_pack_vjp.launches)
    got = lp.lora_pack(state, L, H, d_pad, row_perm, ALPHA)
    assert lp.lora_pack.launches - before[0] == launches
    want = lp.lora_pack_reference(state, L, H, d_pad, row_perm, ALPHA)
    again = lp.lora_pack(state, L, H, d_pad, row_perm, ALPHA)
    for k, (g, a) in enumerate(zip(got, again)):
        _same(a, g, f"packed {k} second call")
    if state["trunk.0.lora_a"].shape[1] <= lp.TORCH_ORDER_RANK:
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"packed {k} vs plain")
    else:  # the kernel's float64 sums: near the plain packing, no further from float64
        exact = lp.lora_pack_reference({k: v.double() for k, v in state.items()}, L, H, d_pad,
                                       row_perm, ALPHA)
        for k, (g, w, e) in enumerate(zip(got, want, exact)):
            assert _rel([g], [w]) <= 1e-6, (k, _rel([g], [w]))
            assert _rel([g], [e]) <= _rel([w], [e]), (k, _rel([g], [e]), _rel([w], [e]))
            if k not in (0, 2):
                _same(g, w, f"packed {k} (data movement) vs plain")
    cots = tuple(_cotangents([w.shape for w in want], seed, state["trunk.0.lora_a"].device))
    kg = lp.lora_pack_vjp(state, cots, L, H, row_perm, ALPHA)
    assert lp.lora_pack_vjp.launches - before[1] == launches
    ag = lp.lora_pack_vjp_reference(state, cots, L, H, row_perm, ALPHA)
    k2 = lp.lora_pack_vjp(state, cots, L, H, row_perm, ALPHA)
    f64 = lp.lora_pack_vjp_reference({k: v.double() for k, v in state.items()},
                                     tuple(c.double() for c in cots), L, H, row_perm, ALPHA)
    assert list(kg) == list(state)
    for name in state:
        _same(k2[name], kg[name], f"{name} second call")
        if "lora" not in name:
            _same(kg[name], ag[name], name)
    lora = [n for n in state if "lora" in n]
    rel = max(_rel([kg[n]], [ag[n]]) for n in lora)
    # each LoRA tensor no further from float64 than autograd's
    gap = {n: _rel([kg[n]], [f64[n]]) - _rel([ag[n]], [f64[n]]) for n in lora}
    worst = max(gap, key=gap.get)
    assert rel <= 1e-6, rel
    assert gap[worst] <= 0, (worst, gap[worst])
    return rel, gap[worst]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_lora_pack_kernels_match_plain(h100, case):
    _, in_dim, H, L, rank, perm, zero_b = case
    state, row_perm, d_pad = card_case(h100, in_dim, H, L, rank, perm, zero_b)
    check_card_case(state, row_perm, d_pad, L, H)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", RANKS)
def test_lora_pack_kernels_at_every_rank(h100, rank):
    state, row_perm, d_pad = card_case(h100, 90, 128, 3, rank, True, False, seed=rank)
    check_card_case(state, row_perm, d_pad, 3, 128)


def _check_step_on_the_card(h100, monkeypatch, layers=N_LAYERS, rank=4):
    """A kernel-path step of a LoRA trunk of ``layers`` layers at ``rank``:
    kernel 1 once, the packing and the VJP ceil(layers / 32) times each,
    into the gradient buffer, and no call into the autograd engine."""
    state, args, kw = _trunk_step_inputs(layers=layers, rank=rank)
    state = {k: v.to(h100).contiguous() for k, v in state.items()}
    ro, rd, tgt, mask, *rest = args
    args = (ro.to(h100), rd.to(h100), tgt.to(h100), mask.to(h100), *rest)
    proj = torch.randn((3, 64), generator=torch.Generator().manual_seed(2)).to(h100)
    kw = dict(kw, uniforms=kw["uniforms"].to(h100), point_features_fn=lambda p: torch.sin(p @ proj))

    def refuse(*a, **k):
        raise AssertionError("the autograd engine was entered")

    monkeypatch.setattr(torch.autograd, "grad", refuse)
    monkeypatch.setattr(torch.autograd, "backward", refuse)
    before = (lp.lora_pack.launches, lp.lora_pack_vjp.launches,
              tt.fused_train_objective.launches["train_pe"])
    buf, views = tt.grad_buffer(state, layers)
    loss, grads = tt.fused_train_loss_grad(state, *args, grad_buffer=buf, **kw)
    after = (lp.lora_pack.launches, lp.lora_pack_vjp.launches,
             tt.fused_train_objective.launches["train_pe"])
    packs = -(-layers // 32)
    assert [b - a for a, b in zip(before, after)] == [packs, packs, 1]
    assert all(grads[k].data_ptr() == views[k].data_ptr() for k in state)
    assert torch.isfinite(loss) and torch.isfinite(buf).all()


@pytest.mark.cuda
def test_lora_trunk_step_launches_both_kernels_and_no_autograd(h100, monkeypatch):
    """A kernel-path step of a LoRA trunk: kernel 1, the packing and the VJP
    once each, into the gradient buffer, and no call into the autograd
    engine."""
    _check_step_on_the_card(h100, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,rank", [(8, 1024), (40, 4)])
def test_deep_and_high_rank_lora_steps_launch_the_kernels_and_no_autograd(h100, monkeypatch,
                                                                          layers, rank):
    """``lora_nerf_trunk.yaml``'s step at rank 1024 (the merge's float64
    sums) and at 40 layers (two launches of each LoRA pack kernel): kernel 1
    once, each pack kernel ceil(layers / 32) times, no autograd engine."""
    _check_step_on_the_card(h100, monkeypatch, layers, rank)


@pytest.mark.cuda
def test_differentiable_render_takes_the_vjp_kernel_as_the_packings_backward(h100):
    """``pack_params`` of a LoRA trunk that requires grad, through the
    differentiable render (kernels 4 and 3): the parameters' gradients by
    one launch of the VJP kernel, the base, bias and head ones bit-equal to
    autograd through the plain packing of the same render, ``lora_a`` /
    ``lora_b`` within rel 1e-6."""
    state, _, d_pad = card_case(h100, 90, 128, 3, 4, False, False, signed_zeros=False)
    d_pad = tk.D_PAD
    rng = np.random.default_rng(6)
    R, S = 64, 32
    x = torch.from_numpy(rng.standard_normal((R * S, d_pad)).astype(np.float32) * 0.5).to(h100)
    z = torch.from_numpy(np.sort(rng.uniform(2, 6, (R, S)), axis=1).astype(np.float32)).to(h100)
    dnorm = torch.ones((R, 1), device=h100)

    def grads(pack):
        leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
        packed = pack(leaves)
        rgb, depth, acc, _ = tk.fused_render(x, z, dnorm, packed)
        (rgb.square().sum() + depth.sum() + acc.sum()).backward()
        return {k: v.grad for k, v in leaves.items()}

    before = (lp.lora_pack.launches, lp.lora_pack_vjp.launches)
    got = grads(lambda s: tk.pack_params(s, 3, 128, d_pad, lora_alpha=ALPHA))
    assert (lp.lora_pack.launches, lp.lora_pack_vjp.launches) == (before[0] + 1, before[1] + 1)
    want = grads(lambda s: lp.lora_pack_reference(s, 3, 128, d_pad, None, ALPHA))
    for name in state:
        if "lora" in name:
            assert _rel([got[name]], [want[name]]) <= 1e-6, name
        else:
            _same(got[name], want[name], name)
