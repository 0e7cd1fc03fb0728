"""The CUDA kernels against their plain PyTorch versions, on the card: the
inline-PE render kernel (``csrc/fwd_pe.cu``) and the training objective
(``csrc/train_pe.cu``, inline PE and pre-encoded x).

Marked ``cuda``: each test skips unless an sm_90 card is present (decided
inside the test, never at collection). On the card, run without the JAX
conftest (the card machine has no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: the kernel sums the fp32 trunk products in k order with FMAs,
cuBLAS in its own blocked order; with the PE phases and sinf identical to
~1 ulp, rgb/acc/weights agree to 1e-4 and depth (up to 6) to 1e-3.
The training objective: loss to rel 1e-5, the six packed gradients as one
vector to rel 1e-4 (fp32 sums in other orders through a 2-9 layer chain),
and to rel 2e-2 at sigma_bias 5.0, where the backward divides by
transmittances at the 1e-10 floor (the JAX package's gate, render/verify.py
GRAD_REL_TOL).
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
@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_trainer_on_the_card_refuses_configs_the_kernels_cannot_take(h100, backend):
    """A trunk width the kernels do not take raises on the card in
    ``train_epoch`` and in eval, with ``auto`` as with ``fused``: no step
    or view falls back to the plain path and no kernel is launched."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict({
        "data": {"resolution": 16}, "nerf_model": {"hidden_dim": 64, "num_layers": 2},
        "training": {"phases": [{"start": 0, "H": 16, "n_samples": 16, "batch_size": 64}]},
        "rendering": {"chunk_size": 64, "backend": backend},
    })
    data = make_scene_dataset(lego_like_scene(), 1, img_size=16, gt_samples=16, device="cpu")
    tr = Trainer(cfg, data, data, device=h100)
    before = dict(tt.fused_train_objective.launches)
    with pytest.raises(ValueError, match=f"backend={backend} rejected on cuda"):
        tr.train_epoch(0)
    with pytest.raises(ValueError, match=f"backend={backend} rejected on cuda"):
        tr.render_views(data.poses[:1])
    assert tt.fused_train_objective.launches == before
