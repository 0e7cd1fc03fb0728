"""The CUDA kernels against their plain PyTorch versions, on the card: the
inline-PE render kernel and the render from a pre-encoded x
(``csrc/fwd_pe.cu``, kernels 2 and 4), the training objective and the
render VJP (``csrc/train_pe.cu``, kernels 1, 5 and 3), and the paths that
run them.

Marked ``cuda``: each test skips unless an sm_90 card is present (decided
inside the test, never at collection). On the card, run without the JAX
conftest (the card machine has no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: the render kernels (2, 4) take their trunk products as 3xTF32
on the tensor cores (~2^-22 off each, ~fp32 accuracy) and sum them in
another order than cuBLAS; with the PE phases and sinf identical to ~1 ulp,
rgb/acc/weights agree to 1e-4 and depth (up to 6) to 1e-3. The training objective (kernels 1, 5), whose trunk products run as
3xTF32 on the tensor cores (~fp32 accuracy): loss to rel 1e-5, the six
packed gradients as one vector to rel 1e-4 (sums in other orders through a
2-9 layer chain),
and to rel 2e-2 at sigma_bias 5.0, where the backward divides by
transmittances at the 1e-10 floor (the JAX package's gate, render/verify.py
GRAD_REL_TOL). The render VJP: dx and the six packed gradients as one
vector, with the same two tolerances.
"""

import numpy as np
import pytest
import torch

from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt

TOL = {"rgb": 1e-4, "depth": 1e-3, "acc": 1e-4, "weights": 1e-4}


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip(f"{torch.cuda.get_device_name(0)} is not sm_90")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(R, S, H, L, feat_dim, device, seed=0):
    """chip_smoke's random kernel inputs: torch-default-bounded weights,
    points in the scene box, depths in [2, 6]."""
    import chip_smoke

    return chip_smoke.random_fwd_pe_args(np.random.default_rng(seed), R, S, H, L, feat_dim, device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 48, 64, 192])
@pytest.mark.parametrize("H,L", [(256, 8), (128, 3)])
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("feat_dim", [0, 64])
def test_fwd_pe_kernel_matches_plain(h100, S, H, L, white_bkgd, feat_dim):
    args = _inputs(37, S, H, L, feat_dim, h100)
    use_feats = feat_dim > 0
    before = tk.fused_render_fwd_pe.launches
    got = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=use_feats)
    torch.cuda.synchronize()
    assert tk.fused_render_fwd_pe.launches == before + 1
    want = tk.fused_render_fwd_pe_reference(*args, white_bkgd=white_bkgd, use_feats=use_feats)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


def _fwd_case(kernel, R, S, H, L, feat_dim, device, seed=0):
    """Random inputs of kernel 2 (inline PE, the input padded to a multiple of
    16 as the port's glue pads it) or kernel 4 (a pre-encoded x, 128 wide, or
    256 with features), and the (kernel, plain version) pair."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    if kernel == 2:
        args = chip_smoke.random_fwd_pe_args(rng, R, S, H, L, feat_dim, device,
                                             d_pad=tk.pe_width(90 + feat_dim))
        kw = dict(use_feats=feat_dim > 0)
        return (args, kw, tk.fused_render_fwd_pe, tk.fused_render_fwd_pe_reference)
    args, _ = chip_smoke.random_render_args(rng, R, S, H, L, device, feat_dim=feat_dim)
    return args, {}, tk.fused_render_fwd, tk.fused_render_reference


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [2, 4])
def test_fwd_kernels_are_deterministic(h100, kernel):
    """Kernels 2 and 4 on a 2048 x 64 eval chunk: two calls agree bit for bit
    (no atomics; each tile's sums in a fixed order)."""
    args, kw, fn, _ = _fwd_case(kernel, 2048, 64, 256, 8, 0, h100)
    a = fn(*args, **kw)
    b = fn(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


FWD_CASES = {
    # R*S = 1776 points: the last 64-point tile of the trunk is ragged
    "k2_ragged_white_feats": (2, 37, 48, 256, 8, 64, True),
    "k4_ragged_white_feats_x256_h128": (4, 37, 48, 128, 3, 64, True),
    "k2_max_samples": (2, 3, tk.MAX_SAMPLES, 256, 8, 0, False),
    "k4_max_samples": (4, 3, tk.MAX_SAMPLES, 256, 8, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_fwd_kernels_at_the_edges(h100, case):
    """Kernels 2 and 4 where the point tiles and the compositing meet their
    edges: R*S not a multiple of the tile (with a white background and
    features; kernel 4 with a 256-wide x through an H 128 trunk) and S =
    MAX_SAMPLES; against their plain versions at the view tolerances."""
    kernel, R, S, H, L, feat_dim, white = FWD_CASES[case]
    args, kw, fn, ref = _fwd_case(kernel, R, S, H, L, feat_dim, h100)
    if kernel == 4:
        assert args[0].shape[1] == (256 if feat_dim else 128)
    got = fn(*args, white_bkgd=white, **kw)
    torch.cuda.synchronize()
    want = ref(*args, white_bkgd=white, **kw)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


@pytest.mark.cuda
def test_fwd_pe_wrapper_checks_its_inputs(h100):
    raw, feats, z, dnorm, e2, c, packed = _inputs(4, 32, 256, 2, 0, h100)
    with pytest.raises(ValueError, match="contiguous float32"):
        tk.fused_render_fwd_pe(raw.double(), feats, z, dnorm, e2, c, packed)
    with pytest.raises(ValueError, match="contiguous float32"):
        tk.fused_render_fwd_pe(raw, feats, z.t().contiguous().t(), dnorm, e2, c, packed)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_render_fwd_pe(raw[:-1], feats, z, dnorm, e2, c, packed)
    with pytest.raises(ValueError, match="on cpu"):
        tk.fused_render_fwd_pe(raw, feats, z.cpu(), dnorm, e2, c, packed)


@pytest.mark.cuda
def test_trainer_on_the_card_matches_the_cpu(h100):
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict({
        "data": {"resolution": 24}, "nerf_model": {"sigma_bias": 0.1},
        "training": {"phases": [{"start": 0, "H": 24, "n_samples": 64, "batch_size": 256}]},
        "rendering": {"chunk_size": 256},
    })
    test = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, split="test",
                              device="cpu")
    before = tk.fused_render_fwd_pe.launches
    gpu = Trainer(cfg, test, test, device=h100)
    cpu = Trainer(cfg, test, test, device="cpu")
    got, want = gpu.render_views(test.poses), cpu.render_views(test.poses)
    assert tk.fused_render_fwd_pe.launches - before == -(-2 * 24 * 24 // 256)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[name], err_msg=name)


TRAIN_CASES = {
    "plain": {},
    "white_masked_reg_depth_feats": dict(white_bkgd=True, ragged=7, reg_weight=0.01,
                                         depth_weight=0.1, feat_dim=64),
    "x_input": dict(inline_pe=False),
    "x_input_masked_reg_depth_feats": dict(inline_pe=False, ragged=7, reg_weight=0.01,
                                           depth_weight=0.1, feat_dim=64),
    "sigma_bias_5": dict(sigma_bias=5.0),
}


def _train_inputs(R, S, H, L, device, seed=0, **case):
    import chip_smoke

    return chip_smoke.random_train_args(np.random.default_rng(seed), R, S, H, L, device, **case)


def _check_train(got, want, grad_tol):
    (gl, gd), (wl, wd) = got, want
    g = torch.cat([t.reshape(-1).double() for t in gd])
    w = torch.cat([t.reshape(-1).double() for t in wd])
    assert torch.isfinite(gl) and torch.isfinite(g).all()
    assert w.norm().item() > 1e-6
    assert abs(gl.item() - wl.item()) <= 1e-5 * abs(wl.item())
    rel = ((g - w).norm() / w.norm()).item()
    assert rel <= grad_tol, rel
    for a, b in zip(gd, wd):
        assert a.shape == b.shape


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 48, 64])
@pytest.mark.parametrize("H,L", [(256, 8), (128, 3)])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_kernel_matches_plain(h100, S, H, L, case):
    args, opts = _train_inputs(37, S, H, L, h100, **TRAIN_CASES[case])
    name = "train_pe" if opts["inline_pe"] else "train_x"
    before = tt.fused_train_objective.launches[name]
    got = tt.fused_train_objective(*args, **opts)
    torch.cuda.synchronize()
    assert tt.fused_train_objective.launches[name] == before + 1
    want = tt.fused_train_objective_reference(*args, **opts)
    _check_train(got, want, 2e-2 if case == "sigma_bias_5" else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(300, 64), (512, 64)])
def test_train_kernel_split_sums_are_deterministic(h100, R, S):
    """Above 8192 points the dW products split the point axis in parts;
    the parts are summed in a fixed order, so two calls agree bit for bit."""
    args, opts = _train_inputs(R, S, 256, 8, h100, ragged=3)
    a = tt.fused_train_objective(*args, **opts)
    b = tt.fused_train_objective(*args, **opts)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    _check_train(a, tt.fused_train_objective_reference(*args, **opts), 1e-4)


@pytest.mark.cuda
def test_train_kernel_at_the_hierarchical_shape(h100):
    """The hierarchical phase-2 step: 512 rays x 128 merged samples, 65,536
    points, so the dW products split the point axis into 8 parts of 8,192:
    two calls agree bit for bit and match the plain version."""
    args, opts = _train_inputs(512, 128, 256, 8, h100)
    a = tt.fused_train_objective(*args, **opts)
    b = tt.fused_train_objective(*args, **opts)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    _check_train(a, tt.fused_train_objective_reference(*args, **opts), 1e-4)


@pytest.mark.cuda
def test_train_wrapper_checks_its_inputs(h100):
    args, opts = _train_inputs(4, 32, 128, 2, h100)
    raw, feats, z, dnorm, tgt, mask, inv_denom, e2, c, packed = args
    with pytest.raises(ValueError, match="contiguous float32"):
        tt.fused_train_objective(raw.double(), *args[1:], **opts)
    with pytest.raises(ValueError, match="shape"):
        tt.fused_train_objective(raw, feats, z, dnorm, tgt[:-1], mask, inv_denom, e2, c, packed,
                                 **opts)
    with pytest.raises(ValueError, match="on cpu|on cuda"):
        tt.fused_train_objective(raw, feats, z, dnorm, tgt, mask.cpu(), inv_denom, e2, c, packed,
                                 **opts)
    with pytest.raises(NotImplementedError):
        tt.fused_train_objective(*args, **{**opts, "compute_dtype": "bfloat16"})


@pytest.mark.cuda
def test_train_epoch_on_the_card_matches_the_cpu(h100, monkeypatch):
    """The trainer on the card launches the kernel once per step and gives
    the CPU trainer's epoch losses (jitter off: the two devices' generators
    draw different numbers); parameter changes agree as one vector."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    orig = Trainer._render_settings
    monkeypatch.setattr(Trainer, "_render_settings", lambda self, n, training: orig(self, n, False))
    cfg = config_from_dict({
        "data": {"resolution": 24}, "nerf_model": {"sigma_bias": 0.1},
        "training": {"phases": [{"start": 0, "end": 1, "H": 12, "n_samples": 32, "batch_size": 100},
                                {"start": 1, "H": 24, "n_samples": 48, "batch_size": 256}]},
        "rendering": {"chunk_size": 256},
    })
    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    gpu = Trainer(cfg, data, data, device=h100)
    cpu = Trainer(cfg, data, data, device="cpu")
    start = {k: v.cpu().clone() for k, v in gpu.model.state_dict().items()}
    before = tt.fused_train_objective.launches["train_pe"]
    for epoch in (0, 1):
        got, want = gpu.train_epoch(epoch), cpu.train_epoch(epoch)
        np.testing.assert_allclose(gpu.last_step_losses, cpu.last_step_losses, rtol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tt.fused_train_objective.launches["train_pe"] - before == 2 * 2 + 2 * 3
    dg = torch.cat([(v.cpu() - start[k]).reshape(-1) for k, v in gpu.model.state_dict().items()])
    dc = torch.cat([(v - start[k]).reshape(-1) for k, v in cpu.model.state_dict().items()])
    assert ((dg - dc).norm() / dc.norm()).item() < 2e-3
    assert gpu.dead_sigma_probe() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width,backend", [(64, "auto"), (64, "fused"), (384, "auto"),
                                           (384, "fused")])
def test_trainer_on_the_card_refuses_configs_the_kernels_cannot_take(h100, width, backend):
    """As the JAX trainer: width 64, which the JAX kernels do not take,
    trains on the plain path under ``auto`` (no kernel launched,
    ``kernel_path`` "plain" with the JAX reason) and raises under ``fused``.
    Width 384, which the JAX kernels take and the port has no CUDA build
    for, raises on the card in ``train_epoch`` and in eval under both: no
    step or view falls back to the plain path."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict({
        "data": {"resolution": 16}, "nerf_model": {"hidden_dim": width, "num_layers": 2},
        "training": {"phases": [{"start": 0, "H": 16, "n_samples": 16, "batch_size": 64}]},
        "rendering": {"chunk_size": 64, "backend": backend},
    })
    data = make_scene_dataset(lego_like_scene(), 1, img_size=16, gt_samples=16, device="cpu")
    tr = Trainer(cfg, data, data, device=h100)
    before = (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches)
    if width == 64 and backend == "auto":
        assert np.isfinite(tr.train_epoch(0))
        assert np.isfinite(tr.render_views(data.poses[:1])[0]).all()
        assert (tr.kernel_path, tr.kernel_path_reason) == ("plain",
                                                           "hidden_dim=64 not 128-lane aligned")
    else:
        with pytest.raises(ValueError, match=f"backend={backend} rejected on cuda"):
            tr.train_epoch(0)
        with pytest.raises(ValueError, match=f"backend={backend} rejected on cuda"):
            tr.render_views(data.poses[:1])
    assert (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches) == before


RENDER_CASES = {
    "plain": {},
    "white": dict(white_bkgd=True),
    "feats": dict(feat_dim=64),
    "sigma_bias_5": dict(sigma_bias=5.0),
}


def _render_inputs(R, S, H, L, device, seed=0, **case):
    import chip_smoke

    rng = np.random.default_rng(seed)
    args, _ = chip_smoke.random_render_args(rng, R, S, H, L, device, **case)
    return args, chip_smoke.random_cotangents(rng, R, S, device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 64, 128])
@pytest.mark.parametrize("H,L", [(256, 8), (128, 3)])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_fwd_x_kernel_matches_plain(h100, S, H, L, case):
    kw = dict(RENDER_CASES[case])
    white = kw.pop("white_bkgd", False)
    (x, z, dnorm, packed), _ = _render_inputs(37, S, H, L, h100, **kw)
    before = tk.fused_render_fwd.launches
    got = tk.fused_render_fwd(x, z, dnorm, packed, white_bkgd=white)
    torch.cuda.synchronize()
    assert tk.fused_render_fwd.launches == before + 1
    want = tk.fused_render_reference(x, z, dnorm, packed, white_bkgd=white)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


def _check_vjp(got, want, tol):
    flat = lambda dx, dp: torch.cat([t.reshape(-1).double() for t in (dx, *dp)])
    g, w = flat(*got), flat(*want)
    assert torch.isfinite(g).all()
    assert w.norm().item() > 1e-6
    rel = ((g - w).norm() / w.norm()).item()
    assert rel <= tol, rel
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert a.shape == b.shape


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 64, 128])
@pytest.mark.parametrize("H,L", [(256, 8), (128, 3)])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_bwd_kernel_matches_plain(h100, S, H, L, case):
    kw = dict(RENDER_CASES[case])
    white = kw.pop("white_bkgd", False)
    (x, z, dnorm, packed), cot = _render_inputs(37, S, H, L, h100, **kw)
    before = tk.fused_render_bwd.launches
    got = tk.fused_render_bwd(x, z, dnorm, packed, *cot, white_bkgd=white)
    torch.cuda.synchronize()
    assert tk.fused_render_bwd.launches == before + 1
    want = tk.fused_render_bwd_reference(x, z, dnorm, packed, *cot, white_bkgd=white)
    _check_vjp(got, want, 2e-2 if case == "sigma_bias_5" else 1e-4)
    # without dx: the same packed gradients, bit for bit, and no dx
    dx, dpacked = tk.fused_render_bwd(x, z, dnorm, packed, *cot, white_bkgd=white,
                                      need_dx=False)
    assert dx is None
    for a, b in zip(dpacked, got[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(300, 64), (512, 64)])
def test_render_bwd_kernel_is_deterministic(h100, R, S):
    """Above 8192 points the dW products split the point axis in parts,
    summed in a fixed order: two calls agree bit for bit."""
    (x, z, dnorm, packed), cot = _render_inputs(R, S, 256, 8, h100)
    a = tk.fused_render_bwd(x, z, dnorm, packed, *cot)
    b = tk.fused_render_bwd(x, z, dnorm, packed, *cot)
    torch.cuda.synchronize()
    for p, q in zip((a[0], *a[1]), (b[0], *b[1])):
        assert torch.equal(p, q)
    _check_vjp(a, tk.fused_render_bwd_reference(x, z, dnorm, packed, *cot), 1e-4)


@pytest.mark.cuda
def test_render_wrappers_check_their_inputs(h100):
    (x, z, dnorm, packed), cot = _render_inputs(4, 32, 128, 2, h100)
    with pytest.raises(ValueError, match="contiguous float32"):
        tk.fused_render_fwd(x.double(), z, dnorm, packed)
    with pytest.raises(ValueError, match="x has shape"):
        tk.fused_render_fwd(x[:, :96].contiguous(), z, dnorm, packed)
    with pytest.raises(ValueError, match="x width 96"):
        tk.fused_render_fwd(x[:, :96].contiguous(), z, dnorm,
                            (packed[0][:96].contiguous(), *packed[1:]))
    with pytest.raises(ValueError, match="shape"):
        tk.fused_render_bwd(x, z, dnorm, packed, cot[0][:-1], *cot[1:])
    with pytest.raises(ValueError, match="on cpu|on cuda"):
        tk.fused_render_bwd(x, z, dnorm, packed, cot[0].cpu(), *cot[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_fused_render_launches_kernels_4_and_3_and_matches_autograd(h100, white_bkgd):
    """``fused_render`` on CUDA tensors: one kernel-4 launch forward, one
    kernel-3 launch backward; the gradients of x and of the packed weights
    equal autograd's through the plain version (as one vector, rel 1e-4)."""
    (x, z, dnorm, packed), cot = _render_inputs(64, 64, 256, 8, h100)
    before = (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches)
    leaves = [x.clone().requires_grad_(True)] + [p.clone().requires_grad_(True) for p in packed]
    outs = tk.fused_render(leaves[0], z, dnorm, tuple(leaves[1:]), white_bkgd=white_bkgd)
    torch.autograd.backward(outs, cot)
    torch.cuda.synchronize()
    assert (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    want = tk.fused_render_reference(ref[0], z, dnorm, tuple(ref[1:]), white_bkgd=white_bkgd)
    torch.autograd.backward(want, cot)
    for g, w, name in zip(outs, want, ("rgb", "depth", "acc", "weights")):
        assert (g - w).abs().max().item() <= TOL[name], name
    _check_vjp((leaves[0].grad, [t.grad for t in leaves[1:]]),
               (ref[0].grad, [t.grad for t in ref[1:]]), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_importance", [0, 32])
def test_differentiable_fused_render_rays_on_the_card_matches_the_cpu(h100, n_importance):
    """``fused_render_rays(forward_only=False)`` of a NeRFMLP, perturbed, with
    an rgb + w^2 + depth + acc loss: outputs and parameter gradients on the
    card against the CPU's plain versions (gradients as one vector, rel
    1e-4); kernel 4 runs once per pass, kernel 3 once."""
    from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
    from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings

    rng = np.random.default_rng(3)
    R, S = 128, 32
    d = rng.standard_normal((R, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    data = [np.broadcast_to([0.0, 0.0, 4.0], (R, 3)), d, rng.uniform(0, 1, (R, 3)),
            rng.uniform(0, 1, (R, S)), rng.uniform(0, 1, (R, max(n_importance, 1)))]
    settings = RenderSettings(n_samples=S, n_importance=n_importance, perturb=True)
    results = []
    for device in (h100, torch.device("cpu")):
        model = NeRFMLP(10, 4, True, hidden_dim=256, num_layers=8, sigma_bias_init=0.1,
                        generator=torch.Generator().manual_seed(0)).to(device)
        ro, rd, tgt, u, ui = (torch.tensor(np.asarray(a, np.float32), device=device)
                              for a in data)
        before = (tk.fused_render_fwd.launches, tk.fused_render_bwd.launches)
        out = fused_render_rays(dict(model.named_parameters()), ro, rd, settings, 10, 4, 8, 256,
                                device=device, uniforms=u, importance_uniforms=ui)
        loss = (torch.mean((out.rgb - tgt) ** 2) + 0.01 * torch.mean(out.weights ** 2)
                + 1e-3 * torch.mean(torch.abs(out.depth - 4.0)) + 1e-3 * torch.mean(out.acc))
        loss.backward()
        launches = (tk.fused_render_fwd.launches - before[0],
                    tk.fused_render_bwd.launches - before[1])
        assert launches == ((2 if n_importance else 1, 1) if device.type == "cuda" else (0, 0))
        results.append((loss.item(), torch.cat([p.grad.reshape(-1).double().cpu()
                                                for p in model.parameters()])))
    (lg, gg), (lc, gc) = results
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert ((gg - gc).norm() / gc.norm()).item() <= 1e-4


@pytest.mark.cuda
def test_hierarchical_train_epoch_on_the_card_matches_the_cpu(h100, monkeypatch):
    """A hierarchical config trains on the card through kernel 2 (the coarse
    pass) and kernel 1 (the objective over the merged samples), each once
    per step, and gives the CPU trainer's per-step losses (jitter off)."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    orig = Trainer._render_settings
    monkeypatch.setattr(Trainer, "_render_settings", lambda self, n, training: orig(self, n, False))
    cfg = config_from_dict({
        "data": {"resolution": 24}, "nerf_model": {"sigma_bias": 0.1},
        "training": {"phases": [{"start": 0, "H": 24, "n_samples": 32, "batch_size": 192}]},
        "rendering": {"chunk_size": 256, "n_importance": 32},
    })
    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    gpu = Trainer(cfg, data, data, device=h100)
    cpu = Trainer(cfg, data, data, device="cpu")
    before = (tt.fused_train_objective.launches["train_pe"], tk.fused_render_fwd_pe.launches)
    got, want = gpu.train_epoch(0), cpu.train_epoch(0)
    np.testing.assert_allclose(gpu.last_step_losses, cpu.last_step_losses, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    steps = len(gpu.last_step_losses)
    assert (tt.fused_train_objective.launches["train_pe"] - before[0],
            tk.fused_render_fwd_pe.launches - before[1]) == (steps, steps)
    assert gpu.kernel_path == "kernel"
    # the hierarchical eval render (kernel 2 for both passes) at equal weights
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    g, c = gpu.render_views(data.poses[:1]), cpu.render_views(data.poses[:1])
    for a, b, name in zip(g, c, ("rgb", "depth", "acc")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL[name], err_msg=name)


DINO_WIDTHS = [(64, 176), (128, 240)]  # features, padded input width at pos_freq 12


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("feat_dim,D", DINO_WIDTHS)
def test_fwd_pe_kernel_at_the_dino_widths(h100, feat_dim, D, white_bkgd):
    """Kernel 2 on a 1024 x 64 eval chunk (the DINO configs' chunk_size) at
    pos_freq 12, its input padded to a multiple of 16 as the port's glue
    pads it (10 zero columns)."""
    import chip_smoke

    args = chip_smoke.random_fwd_pe_args(np.random.default_rng(3), 1024, 64, 256, 8, feat_dim,
                                         h100, pos_freq=12, d_pad=tk.pe_width(102 + feat_dim))
    assert args[-1][0].shape[0] == D
    got = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=True)
    want = tk.fused_render_fwd_pe_reference(*args, white_bkgd=white_bkgd, use_feats=True)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "white_masked_reg_depth"])
@pytest.mark.parametrize("feat_dim,D", DINO_WIDTHS)
def test_train_kernel_at_the_dino_widths(h100, feat_dim, D, case):
    """Kernel 1 at 512 x 64 and pos_freq 12 with the DINO feature widths;
    two calls bit-equal."""
    kw = {} if case == "plain" else dict(white_bkgd=True, ragged=9, reg_weight=0.01,
                                         depth_weight=0.1)
    args, opts = _train_inputs(512, 64, 256, 8, h100, feat_dim=feat_dim, pos_freq=12, **kw)
    assert args[-1][0].shape[0] == D
    a = tt.fused_train_objective(*args, **opts)
    b = tt.fused_train_objective(*args, **opts)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    _check_train(a, tt.fused_train_objective_reference(*args, **opts), 1e-4)
    # the pad rows of w0 (past the 102 + feat_dim live columns) get no gradient
    assert torch.count_nonzero(a[1][0][102 + feat_dim:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("feat_dim", [64, 128])
def test_render_bwd_kernel_dx_at_the_dino_widths(h100, feat_dim):
    """Kernel 3 with dx on the pre-encoded x of pos_freq 12 and the DINO
    feature widths (x 256 wide, 90 or 26 zero columns): dx and the packed
    gradients against the plain version; dx of the pad columns is 0."""
    (x, z, dnorm, packed), cot = _render_inputs(512, 64, 256, 8, h100, feat_dim=feat_dim,
                                                pos_freq=12)
    assert x.shape[1] == 256
    got = tk.fused_render_bwd(x, z, dnorm, packed, *cot)
    _check_vjp(got, tk.fused_render_bwd_reference(x, z, dnorm, packed, *cot), 1e-4)
    assert torch.count_nonzero(got[0][:, 102 + feat_dim:]) == 0


LORA_D = 160  # pos_freq 10, view directions, 64 features: 154 live columns


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_fwd_pe_kernel_at_the_lora_trunk_width(h100, white_bkgd):
    """Kernel 2 on a 1024 x 64 chunk at ``lora_nerf_trunk.yaml``'s input
    width (D 160, six zero columns); two calls bit-equal."""
    import chip_smoke

    args = chip_smoke.random_fwd_pe_args(np.random.default_rng(5), 1024, 64, 256, 8, 64, h100,
                                         pos_freq=10, d_pad=tk.pe_width(90 + 64))
    assert args[-1][0].shape[0] == LORA_D
    got = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=True)
    again = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tk.fused_render_fwd_pe_reference(*args, white_bkgd=white_bkgd, use_feats=True)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [512, 1024])
@pytest.mark.parametrize("case", ["plain", "white_masked_reg_depth"])
def test_train_kernel_at_the_lora_trunk_width(h100, R, case):
    """Kernel 1 at R x 64 and D 160 against its plain version; the pad rows
    of w0 get no gradient."""
    kw = {} if case == "plain" else dict(white_bkgd=True, ragged=9, reg_weight=0.01,
                                         depth_weight=0.1)
    args, opts = _train_inputs(R, 64, 256, 8, h100, feat_dim=64, **kw)
    assert args[-1][0].shape[0] == LORA_D
    got = tt.fused_train_objective(*args, **opts)
    _check_train(got, tt.fused_train_objective_reference(*args, **opts), 1e-4)
    assert torch.count_nonzero(got[1][0][154:]) == 0


@pytest.mark.cuda
def test_lora_trainer_on_the_card_matches_its_xla_twin(h100):
    """A trunk-LoRA trainer (rank 4, 64-wide features: D 160) through
    kernels 1 and 2 against a ``backend: xla`` trainer from the same seed on
    the card: per-step losses of epoch 0 and of the freeze (epoch 1) within
    rel 1e-4; one kernel-1 launch per step; base and heads bit-equal across
    the freeze; the views of the trained weights within the view
    tolerances."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.models.lora import lora_label_fn
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    def cfg(backend):
        return config_from_dict({
            "data": {"resolution": 28},
            "model": {"use_dino": True, "dino_model_type": "single_scale"},
            "nerf_model": {"sigma_bias": 0.1, "lora_rank": 4, "lora_alpha": 16},
            "training": {"phases": [{"start": 0, "end": 1, "H": 14, "n_samples": 32,
                                     "batch_size": 98},
                                    {"start": 1, "H": 28, "n_samples": 48, "batch_size": 256}]},
            "optimizer": {"lora_only_after_epoch": 1},
            "rendering": {"chunk_size": 392, "backend": backend},
        })

    data = make_scene_dataset(lego_like_scene(), 2, img_size=28, gt_samples=64, device="cpu")
    feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    gpu, twin = (Trainer(cfg(b), data, data, device=h100, dino_features=feats)
                 for b in ("auto", "xla"))
    before = tt.fused_train_objective.launches["train_pe"]
    for epoch in (0, 1):
        if epoch == 1:
            frozen = {k: v.clone() for k, v in gpu.model.state_dict().items()
                      if lora_label_fn(k) == "base"}
        gpu.train_epoch(epoch)
        twin.train_epoch(epoch)
        np.testing.assert_allclose(gpu.last_step_losses, twin.last_step_losses, rtol=1e-4)
    assert gpu.kernel_path == "kernel" and gpu._lora_only_active
    assert tt.fused_train_objective.launches["train_pe"] - before == 2 * 2 + 2 * 4
    state = gpu.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in frozen.items())
    twin.model.load_state_dict(state)
    for g, w, name in zip(gpu.render_views(data.poses[:1]), twin.render_views(data.poses[:1]),
                          ("rgb", "depth", "acc")):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[name], err_msg=name)


# The script recipes: pos_freq 10 and 768 patch-embedding features; without
# view directions 831 live columns (D 832), with them 858 (D 864); the
# pre-encoded x of kernels 3, 4 and 5 is 896 wide.
SCRIPT_WIDTHS = [(False, 831, 832), (True, 858, 864)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "white_masked_reg_depth"])
@pytest.mark.parametrize("use_viewdirs,x_dim,D", SCRIPT_WIDTHS)
def test_train_kernel_at_the_script_widths(h100, use_viewdirs, x_dim, D, case):
    """Kernel 1 at 512 x 64 with 768-wide features (layer 0 streamed from
    the scratch in 27 stages of 32 rows): launched once, two calls bit-equal,
    against its plain version at the objective's gates; the pad rows of w0
    get no gradient."""
    kw = {} if case == "plain" else dict(white_bkgd=True, ragged=9, reg_weight=0.01,
                                         depth_weight=0.1)
    args, opts = _train_inputs(512, 64, 256, 8, h100, feat_dim=768, use_viewdirs=use_viewdirs,
                               **kw)
    assert args[-1][0].shape[0] == D
    before = tt.fused_train_objective.launches["train_pe"]
    a = tt.fused_train_objective(*args, **opts)
    b = tt.fused_train_objective(*args, **opts)
    torch.cuda.synchronize()
    assert tt.fused_train_objective.launches["train_pe"] == before + 2
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    _check_train(a, tt.fused_train_objective_reference(*args, **opts), 1e-4)
    assert torch.count_nonzero(a[1][0][x_dim:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("use_viewdirs,x_dim,D", SCRIPT_WIDTHS)
def test_fwd_pe_kernel_at_the_script_widths(h100, use_viewdirs, x_dim, D, white_bkgd):
    """Kernel 2 on a 2048 x 64 eval chunk with 768-wide features (each
    32-column stage of layer 0's input built just before its products):
    two calls bit-equal, the plain version's outputs at the view
    tolerances."""
    import chip_smoke

    args = chip_smoke.random_fwd_pe_args(np.random.default_rng(9), 2048, 64, 256, 8, 768, h100,
                                         d_pad=tk.pe_width(x_dim), use_viewdirs=use_viewdirs)
    assert args[-1][0].shape[0] == D
    got = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=True)
    again = tk.fused_render_fwd_pe(*args, white_bkgd=white_bkgd, use_feats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = tk.fused_render_fwd_pe_reference(*args, white_bkgd=white_bkgd, use_feats=True)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= TOL[name], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [1, 2])
def test_script_width_kernels_at_a_ragged_shape(h100, kernel):
    """Kernels 1 and 2 at D 864 on 37 rays x 48 samples (1,776 points: the
    last 64-point tile ragged), white background and, for kernel 1, a masked
    tail: against their plain versions; kernel 1's pad rows get no
    gradient."""
    import chip_smoke

    if kernel == 1:
        args, opts = _train_inputs(37, 48, 256, 8, h100, feat_dim=768, white_bkgd=True, ragged=5)
        assert args[-1][0].shape[0] == 864
        got = tt.fused_train_objective(*args, **opts)
        _check_train(got, tt.fused_train_objective_reference(*args, **opts), 1e-4)
        assert torch.count_nonzero(got[1][0][858:]) == 0
        return
    args = chip_smoke.random_fwd_pe_args(np.random.default_rng(10), 37, 48, 256, 8, 768, h100,
                                         d_pad=864)
    got = tk.fused_render_fwd_pe(*args, white_bkgd=True, use_feats=True)
    want = tk.fused_render_fwd_pe_reference(*args, white_bkgd=True, use_feats=True)
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert (g - w).abs().max().item() <= TOL[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [3, 4, 5])
def test_x_kernels_at_896(h100, kernel):
    """Kernels 3, 4 and 5 on a pre-encoded x 896 wide (858 live columns: pos
    freq 10, view directions, 768 features) at 512 x 64: launched once per
    call, two calls bit-equal, against their plain versions at the existing
    gates; the pad columns of dx (kernel 3) and the pad rows of w0's
    gradient (kernels 3 and 5) are zero."""
    if kernel == 5:
        args, opts = _train_inputs(512, 64, 256, 8, h100, feat_dim=768, inline_pe=False)
        assert args[0].shape[1] == 896
        before = tt.fused_train_objective.launches["train_x"]
        a = tt.fused_train_objective(*args, **opts)
        b = tt.fused_train_objective(*args, **opts)
        torch.cuda.synchronize()
        assert tt.fused_train_objective.launches["train_x"] == before + 2
        assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        _check_train(a, tt.fused_train_objective_reference(*args, **opts), 1e-4)
        assert torch.count_nonzero(a[1][0][858:]) == 0
        return
    (x, z, dnorm, packed), cot = _render_inputs(512, 64, 256, 8, h100, feat_dim=768)
    assert x.shape[1] == 896
    if kernel == 4:
        before = tk.fused_render_fwd.launches
        got = tk.fused_render_fwd(x, z, dnorm, packed)
        again = tk.fused_render_fwd(x, z, dnorm, packed)
        torch.cuda.synchronize()
        assert tk.fused_render_fwd.launches == before + 2
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        want = tk.fused_render_reference(x, z, dnorm, packed)
        for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
            assert torch.isfinite(g).all(), name
            assert (g - w).abs().max().item() <= TOL[name], name
        return
    before = tk.fused_render_bwd.launches
    got = tk.fused_render_bwd(x, z, dnorm, packed, *cot)
    again = tk.fused_render_bwd(x, z, dnorm, packed, *cot)
    torch.cuda.synchronize()
    assert tk.fused_render_bwd.launches == before + 2
    assert all(torch.equal(p, q) for p, q in zip((got[0], *got[1]), (again[0], *again[1])))
    _check_vjp(got, tk.fused_render_bwd_reference(x, z, dnorm, packed, *cot), 1e-4)
    assert torch.count_nonzero(got[0][:, 858:]) == 0
    assert torch.count_nonzero(got[1][0][858:]) == 0
