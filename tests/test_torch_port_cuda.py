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
    "k2_max_samples": (2, 3, 1024, 256, 8, 0, False),
    "k4_max_samples": (4, 3, 1024, 256, 8, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_fwd_kernels_at_the_edges(h100, case):
    """Kernels 2 and 4 where the point tiles and the compositing meet their
    edges: R*S not a multiple of the tile (with a white background and
    features; kernel 4 with a 256-wide x through an H 128 trunk) and S =
    1024 (the kernels' former cap); against their plain versions at
    the view tolerances."""
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


def _within_gate_or_f64(name, g, w, tol, exact):
    """The gradient vector ``g`` within ``tol`` (rel) of the plain version's
    ``w``; or, when ``exact()`` (a float64 run of the plain version) is
    given, no further from it than ``F64_FACTOR`` times ``w`` is. On a
    37-ray case a new order of the trunk's sums can round one ReLU gate to
    the other side than the fp32 plain version (~7e-4 of the vector), so
    these cases hold the kernel against float64 as well; the reading is
    printed when the second rule decides."""
    rel = ((g - w).norm() / w.norm()).item()
    if rel <= tol or exact is None:
        assert rel <= tol, rel
        return
    e = exact()
    k64 = ((g - e).norm() / e.norm()).item()
    p64 = ((w - e).norm() / e.norm()).item()
    print(f"{name}: rel {rel:.3e} > {tol:.0e} against the plain version; against float64 "
          f"kernel {k64:.3e}, plain {p64:.3e} (ratio {k64 / p64:.2f})")
    assert k64 <= F64_FACTOR * p64, (rel, k64, p64)


F64_FACTOR = 2.0


def _check_train(got, want, grad_tol, exact=None, name=""):
    """``exact``: the float64 objective of the same inputs (a callable), for
    the 37-ray cases' second rule (``_within_gate_or_f64``)."""
    (gl, gd), (wl, wd) = got, want
    g = torch.cat([t.reshape(-1).double() for t in gd])
    w = torch.cat([t.reshape(-1).double() for t in wd])
    assert torch.isfinite(gl) and torch.isfinite(g).all()
    assert w.norm().item() > 1e-6
    assert abs(gl.item() - wl.item()) <= 1e-5 * abs(wl.item())
    f64 = None if exact is None else (
        lambda: torch.cat([t.reshape(-1).double() for t in exact()[1]]))
    _within_gate_or_f64(name, g, w, grad_tol, f64)
    for a, b in zip(gd, wd):
        assert a.shape == b.shape


def _objective_f64(args, opts):
    from nerf_fewshot_tpu_torch.tools.f64_cases import objective_f64

    return lambda: objective_f64(args, opts)


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
    _check_train(got, want, 2e-2 if case == "sigma_bias_5" else 1e-4,
                 _objective_f64(args, opts), f"train_kernel[{case}-{H}-{L}-{S}]")


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
    with pytest.raises(ValueError, match="compute_dtype"):
        tt.fused_train_objective(*args, **{**opts, "compute_dtype": "float16"})
    with pytest.raises(ValueError, match="dw_precision"):
        tt.fused_train_objective(*args, **{**opts, "dw_precision": "default"})


# The precision routes' kernel-vs-plain bounds (measured on an NVIDIA H100
# 80GB HBM3 at 700 W: bfloat16 outputs within 7.4e-5, the render VJP's gradients
# rel 5.1e-4 with standard-normal cotangents on all four outputs, the
# objective rel 1.6e-5: a bf16 rounding that the kernel's and cuBLAS's sum
# orders put on two sides of a tie moves an element by 2^-8 of itself, and
# the suffix sums amplify it; highest as float32).
ROUTE_OUT_ATOL = {"bfloat16": 1e-3, "highest": 1e-4}
ROUTE_GRAD_RTOL = {"bfloat16": 5e-3, "highest": 1e-4}


def _route_case(kernel, device):
    """Random inputs of each kernel at 128 rays x 64 samples, 8x256, and
    its (call, plain version) at a given route, each returning a flat tuple."""
    import chip_smoke

    rng = np.random.default_rng(3)
    if kernel == "fwd_pe":
        a = chip_smoke.random_fwd_pe_args(rng, 128, 64, 256, 8, 64, device, d_pad=176)
        return (lambda cd: tk.fused_render_fwd_pe(*a, compute_dtype=cd, use_feats=True),
                lambda cd: tk.fused_render_fwd_pe_reference(*a, compute_dtype=cd,
                                                            use_feats=True))
    if kernel in ("fwd_x", "render_bwd"):
        a, _ = chip_smoke.random_render_args(rng, 128, 64, 256, 8, device)
        if kernel == "fwd_x":
            return (lambda cd: tk.fused_render_fwd(*a, white_bkgd=True, compute_dtype=cd),
                    lambda cd: tk.fused_render_reference(*a, white_bkgd=True, compute_dtype=cd))
        cot = chip_smoke.random_cotangents(rng, 128, 64, device)
        flat = lambda r: (r[0], *r[1])
        return (lambda cd: flat(tk.fused_render_bwd(*a, *cot, compute_dtype=cd)),
                lambda cd: flat(tk.fused_render_bwd_reference(*a, *cot, compute_dtype=cd)))
    a, o = chip_smoke.random_train_args(rng, 128, 64, 256, 8, device, white_bkgd=True, ragged=9,
                                        reg_weight=0.01, depth_weight=0.1,
                                        inline_pe=kernel == "train_pe")
    flat = lambda r: (r[0].reshape(1), *r[1])
    return (lambda cd: flat(tt.fused_train_objective(*a, **{**o, "compute_dtype": cd})),
            lambda cd: flat(tt.fused_train_objective_reference(*a, **{**o, "compute_dtype": cd})))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "highest"])
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x", "render_bwd", "train_pe", "train_x"])
def test_every_kernel_at_every_route_matches_plain(h100, kernel, compute_dtype):
    """Each of the five kernels at ``bfloat16`` and ``highest`` against its
    plain version at the same route: a second call bit-equal; render
    outputs within ROUTE_OUT_ATOL, gradient vectors (with the loss) within
    ROUTE_GRAD_RTOL; ``bfloat16`` apart from the ``float32`` route."""
    run, plain = _route_case(kernel, h100)
    got, again, f32 = run(compute_dtype), run(compute_dtype), run("float32")
    want = plain(compute_dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.isfinite(t).all() for t in got)
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts])
    if kernel in ("fwd_pe", "fwd_x"):
        dist = lambda a, b: max((x - y).abs().max().item() for x, y in zip(a, b))
        bound, apart = ROUTE_OUT_ATOL[compute_dtype], 1e-5
    else:
        dist = lambda a, b: ((flat(a) - flat(b)).norm() / flat(b).norm()).item()
        bound, apart = ROUTE_GRAD_RTOL[compute_dtype], 1e-4
    assert dist(got, want) <= bound, dist(got, want)
    if compute_dtype == "bfloat16":
        assert dist(got, f32) > apart


# The wide trunks (H 384 and 512: column passes of 128) at every route:
# render outputs within WIDE_OUT_ATOL (TOL, or the bfloat16 route's bound),
# the gradient vectors (with the loss) within WIDE_GRAD_RTOL, or, at float32
# and highest, no further from a float64 run than F64_FACTOR times the
# plain version (``_within_gate_or_f64``: a 37-ray case can round one ReLU
# gate to the other side).
WIDE_OUT_ATOL = {"float32": TOL, "highest": TOL,
                 "bfloat16": {k: ROUTE_OUT_ATOL["bfloat16"] for k in TOL}}
WIDE_GRAD_RTOL = {"float32": 1e-4, "bfloat16": ROUTE_GRAD_RTOL["bfloat16"], "highest": 1e-4}


def _wide_case(kernel, H, device, R=37, S=48, L=4, staged=False):
    """Random inputs of one kernel through an L x H trunk at R x S points
    (37 x 48: the last 64-point tile ragged) with 64 point features, or at
    the script recipes' input (768 features: D 864 inline, an 896-wide x)
    when ``staged``; returns ``(launches(), run(cd), plain(cd), f64(cd))``,
    the calls returning flat tuples."""
    import chip_smoke
    from nerf_fewshot_tpu_torch.tools.f64_cases import objective_f64, to_f64

    rng = np.random.default_rng(11)
    fd = 768 if staged else 64
    if kernel == "fwd_pe":
        a = chip_smoke.random_fwd_pe_args(rng, R, S, H, L, fd, device,
                                          d_pad=tk.pe_width(90 + fd))
        assert a[6][0].shape[0] == (864 if staged else 160)
        return (lambda: tk.fused_render_fwd_pe.launches,
                lambda cd: tk.fused_render_fwd_pe(*a, compute_dtype=cd, use_feats=True),
                lambda cd: tk.fused_render_fwd_pe_reference(*a, compute_dtype=cd,
                                                            use_feats=True), None)
    if kernel in ("fwd_x", "render_bwd"):
        a, _ = chip_smoke.random_render_args(rng, R, S, H, L, device, feat_dim=fd)
        assert a[0].shape[1] == (896 if staged else 256)
        if kernel == "fwd_x":
            return (lambda: tk.fused_render_fwd.launches,
                    lambda cd: tk.fused_render_fwd(*a, white_bkgd=True, compute_dtype=cd),
                    lambda cd: tk.fused_render_reference(*a, white_bkgd=True, compute_dtype=cd),
                    None)
        cot = chip_smoke.random_cotangents(rng, R, S, device)
        flat = lambda r: (r[0], *r[1])
        return (lambda: tk.fused_render_bwd.launches,
                lambda cd: flat(tk.fused_render_bwd(*a, *cot, compute_dtype=cd)),
                lambda cd: flat(tk.fused_render_bwd_reference(*a, *cot, compute_dtype=cd)),
                lambda cd: flat(tk.fused_render_bwd_reference(*to_f64(a), *to_f64(cot),
                                                              compute_dtype=cd)))
    a, o = chip_smoke.random_train_args(rng, R, S, H, L, device, feat_dim=fd, white_bkgd=True,
                                        ragged=5, reg_weight=0.01, depth_weight=0.1,
                                        inline_pe=kernel == "train_pe")
    flat = lambda r: (r[0].reshape(1), *r[1])
    with_cd = lambda cd: {**o, "compute_dtype": cd}
    return (lambda: tt.fused_train_objective.launches[kernel],
            lambda cd: flat(tt.fused_train_objective(*a, **with_cd(cd))),
            lambda cd: flat(tt.fused_train_objective_reference(*a, **with_cd(cd))),
            lambda cd: flat(objective_f64(a, with_cd(cd))))


def _f64_at_a_tie(f64, compute_dtype, flat, g, tol, ties=8, tie=1e-6):
    """The gate rule of the wider trunks: the kernel's gradient vector ``g``
    within ``tol`` (rel) of a float64 run of the plain version (``f64``) in
    which one ReLU gate whose float64 pre-activation is within ``tie`` of
    zero is taken to the other side (the ``ties`` nearest zero tried one at
    a time). Such a gate is a tie at fp32 precision: a 640-term sum of fp32
    products is ~1e-7 off its float64 value, so any order of the sums, the
    kernel's, cuBLAS's or another route's, may land on either side, and
    the vector then moves by ~1e-4 over 1,776 points (read on an NVIDIA
    H100 80GB HBM3 at 700 W: ``train_x`` at H 640, a tie 1.4e-8 from zero
    that both kernel routes take to the other side moves it 1.9e-4).
    Returns the reading, or None when no tie explains ``g``."""
    recorded = []
    real = tk._trunk

    def trunk(x, packed, dtype="float32", head_dtype=None, flip=None):
        w0, b0, wh, bh, wout, bout = packed
        h = x
        for layer in range(wh.shape[0] + 1):
            W, b = (w0, b0) if layer == 0 else (wh[layer - 1], bh[layer - 1])
            z = tk._dot(h, W, dtype) + b
            if flip is None:
                recorded.append(z.detach())
                h = torch.relu(z)
            else:  # the gate of (point n, unit j) flipped; a gate open below 0 reads |z|
                gate = (z > 0).to(z.dtype)
                if flip[0] == layer:
                    gate[flip[1], flip[2]] = 1.0 - gate[flip[1], flip[2]]
                h = z * gate + (gate * (z.abs() - z)).detach()
            if layer == 0:
                states = [x]
            states.append(h)
        return tk._dot(h, wout[:, :4], head_dtype or dtype) + bout[:, :4], states

    def with_trunk(fn):
        tk._trunk = tt._trunk = fn
        try:
            return flat(f64(compute_dtype))
        finally:
            tk._trunk = tt._trunk = real

    with_trunk(trunk)
    near = torch.cat([z.abs().reshape(-1) for z in recorded])
    sizes = [z.numel() for z in recorded]
    best = None
    for i in torch.topk(-near, ties).indices.tolist():
        if near[i] > tie:
            break
        layer = next(k for k in range(len(sizes)) if i < sum(sizes[:k + 1]))
        n, j = divmod(i - sum(sizes[:layer]), recorded[layer].shape[1])
        e = with_trunk(lambda *a, **k: trunk(*a, **k, flip=(layer, n, j)))
        rel = ((g - e).norm() / e.norm()).item()
        if best is None or rel < best[0]:
            best = (rel, layer, n, j, near[i].item())
    return best if best is not None and best[0] <= tol else None


def _check_wide(kernel, H, compute_dtype, case, ties=False):
    """Two calls bit for bit, two launches, finite; then the bounds above;
    ``ties``: a gradient vector that fails them may also pass the gate rule
    of ``_f64_at_a_tie``."""
    launches, run, plain, f64 = case
    before = launches()
    got, again = run(compute_dtype), run(compute_dtype)
    torch.cuda.synchronize()
    assert launches() == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.isfinite(t).all() for t in got)
    want = plain(compute_dtype)
    name = f"{kernel}[{H}-{compute_dtype}]"
    if f64 is None:
        tol = WIDE_OUT_ATOL[compute_dtype]
        for g, w, out in zip(got, want, ("rgb", "depth", "acc", "weights")):
            err = (g - w).abs().max().item()
            assert err <= tol[out], (name, out, err)
        return
    flat = lambda ts: torch.cat([t.reshape(-1).double() for t in ts])
    exact = None if compute_dtype == "bfloat16" else lambda: flat(f64(compute_dtype))
    tol = WIDE_GRAD_RTOL[compute_dtype]
    try:
        _within_gate_or_f64(name, flat(got), flat(want), tol, exact)
    except AssertionError:
        if not ties:
            raise
        reading = _f64_at_a_tie(f64, compute_dtype, flat, flat(got), tol)
        print(f"{name}: the gate rule: {reading} (rel to float64 with one tie flipped, "
              f"layer, point, unit, |z|)")
        assert reading is not None, name


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "highest"])
@pytest.mark.parametrize("H", [384, 512])
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x", "render_bwd", "train_pe", "train_x"])
def test_every_kernel_at_the_wide_trunks_matches_plain(h100, kernel, H, compute_dtype):
    """Each of the five kernels through a 4 x 384 and a 4 x 512 trunk at
    every route, on 37 rays x 48 samples, against its plain version."""
    _check_wide(kernel, H, compute_dtype, _wide_case(kernel, H, h100))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x", "render_bwd", "train_pe", "train_x"])
def test_wide_trunk_kernels_at_the_script_input_widths(h100, kernel):
    """At H 512 an input wider than the trunk streams layer 0 in slices
    (STAGED) in every column pass: kernels 1 and 2 at D 864, kernels 3, 4
    and 5 from an 896-wide x, float32, on 509 rays x 48 samples (the last
    tile ragged). Not 37 rays: there one ReLU gate that the kernel's and
    cuBLAS's fp32 sums round to two sides moves the gradient vector by up
    to 3.5e-4 (read on an NVIDIA H100 80GB HBM3 at 700 W; a 4 x 512 trunk
    over 1,776 points holds ~25 pre-activations within 1e-6 of zero),
    whichever side float64 takes; over 509 rays such a gate weighs 14
    times less."""
    _check_wide(kernel, 512, "float32", _wide_case(kernel, 512, h100, R=509, staged=True))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "highest"])
@pytest.mark.parametrize("H", [640, 768, 1024])
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x", "render_bwd", "train_pe", "train_x"])
def test_every_kernel_at_the_wider_trunks_matches_plain(h100, kernel, H, compute_dtype):
    """Each of the five kernels through a 4 x H trunk past 512 (the
    width-generic build: no activation tile, every layer input streamed
    from its image) at every route, on 37 rays x 48 samples, against its
    plain version at the bounds of the wide trunks, bit-equal on a second
    call; a gradient vector apart from both the plain version and float64
    passes only if one ReLU tie explains it (``_f64_at_a_tie``)."""
    _check_wide(kernel, H, compute_dtype, _wide_case(kernel, H, h100), ties=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd_pe", "fwd_x", "render_bwd", "train_pe", "train_x"])
def test_every_kernel_at_trunk_width_2048_matches_plain(h100, kernel):
    """A 2 x 2048 trunk at float32 (37 rays x 48 samples): shared memory no
    longer bounds the width (the generic build's is the same at every H;
    the 64 x 2056 activation tile alone would take 526 KB)."""
    _check_wide(kernel, 2048, "float32", _wide_case(kernel, 2048, h100, L=2), ties=True)


# Past the caps the kernels once had (the JAX kernels never had
# them): samples per ray past 1024 (the compositing state of kernels 1, 5
# and 3 in shared memory past 48 KB at S 2048 and 2050, in the scratch at S
# 8192), trunks deeper than 15 layers (the dW products in launches of at
# most 16) and inputs wider than 896 columns (D / x 1152), each kernel
# against its plain version at the bounds of the wide trunks (the §2 gates,
# the float64 rule at float32 and highest), bit-equal on a second call.
# The widest case of each cap at all three routes, the rest at float32;
# shapes as chip_smoke.CAP_CASES, plus 37 rays x 2050 samples (the last
# 64-point tile ragged) through a 4 x 256 trunk with 64 features.
CAP_SHAPES = {  # R, S, H, L, features
    "s2048": (64, 2048, 256, 8, 0), "s8192": (16, 8192, 256, 8, 0),
    "l16": (512, 64, 256, 16, 0), "l24": (512, 64, 256, 24, 0),
    "d1152": (512, 64, 256, 8, 1062), "s2048_h512": (64, 2048, 512, 8, 0),
    "l16_h512": (512, 64, 512, 16, 0), "r37_s2050": (37, 2050, 256, 4, 64),
}
CAP_KERNELS = ("fwd_pe", "fwd", "render_bwd", "train_pe", "train_x")
CAP_PARAMS = [(label, kernel, cd) for label in CAP_SHAPES for kernel in CAP_KERNELS
              for cd in (("float32", "bfloat16", "highest")
                         if label in ("s8192", "l24", "d1152") else ("float32",))]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kernel,compute_dtype", CAP_PARAMS)
def test_every_kernel_past_the_old_caps_matches_plain(h100, label, kernel, compute_dtype):
    import chip_smoke

    name, _, run, plain, f64, _, _ = chip_smoke.cap_case(kernel, label, CAP_SHAPES[label], h100)
    counts = {"fwd_pe": lambda: tk.fused_render_fwd_pe.launches,
              "fwd": lambda: tk.fused_render_fwd.launches,
              "render_bwd": lambda: tk.fused_render_bwd.launches,
              "train_pe": lambda: tt.fused_train_objective.launches["train_pe"],
              "train_x": lambda: tt.fused_train_objective.launches["train_x"]}[name]
    forward = kernel in ("fwd_pe", "fwd")
    _check_wide(kernel, CAP_SHAPES[label][2], compute_dtype,
                (counts, run, plain, None if forward else f64))


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
@pytest.mark.parametrize("width,backend", [(64, "auto"), (64, "fused"), (640, "auto"),
                                           (640, "fused"), ("samples", "auto"),
                                           ("samples", "fused"), ("layers", "auto"),
                                           ("layers", "fused")])
def test_trainer_on_the_card_refuses_configs_the_kernels_cannot_take(h100, width, backend):
    """As the JAX trainer: width 64, which the JAX kernels do not take,
    trains on the plain path under ``auto`` (no kernel launched,
    ``kernel_path`` "plain" with the JAX reason) and raises under ``fused``.
    What the port's kernels once refused they now take under both: width
    640 (the width-generic build), 1025 samples per ray (n_samples 16 +
    n_importance 1009) and 16 trunk layers train through kernel 1 (kernel 2
    the coarse pass) and render through kernel 2."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    hidden = width if isinstance(width, int) else 128
    layers = 16 if width == "layers" else 2
    n_importance = 1025 - 16 if width == "samples" else 0
    cfg = config_from_dict({
        "data": {"resolution": 16}, "nerf_model": {"hidden_dim": hidden, "num_layers": layers},
        "training": {"phases": [{"start": 0, "H": 16, "n_samples": 16, "batch_size": 64}]},
        "rendering": {"chunk_size": 64, "backend": backend, "n_importance": n_importance},
    })
    data = make_scene_dataset(lego_like_scene(), 1, img_size=16, gt_samples=16, device="cpu")
    tr = Trainer(cfg, data, data, device=h100)
    before = (dict(tt.fused_train_objective.launches), tk.fused_render_fwd_pe.launches)
    if width in (640, "samples", "layers"):
        assert np.isfinite(tr.train_epoch(0))
        assert (tr.kernel_path, tr.kernel_path_reason) == ("kernel", None)
        steps = len(tr.last_step_losses)
        assert tt.fused_train_objective.launches["train_pe"] - before[0]["train_pe"] == steps
        coarse = steps if n_importance else 0
        assert tk.fused_render_fwd_pe.launches - before[1] == coarse
        assert np.isfinite(tr.render_views(data.poses[:1])[0]).all()
        chunks = -(-16 * 16 // 64)
        assert tk.fused_render_fwd_pe.launches - before[1] == coarse + chunks * (
            2 if n_importance else 1)
        return
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


def _check_vjp(got, want, tol, exact=None, name=""):
    """``exact``: the float64 VJP of the same inputs (a callable), for the
    37-ray cases' second rule (``_within_gate_or_f64``)."""
    flat = lambda dx, dp: torch.cat([t.reshape(-1).double() for t in (dx, *dp)])
    g, w = flat(*got), flat(*want)
    assert torch.isfinite(g).all()
    assert w.norm().item() > 1e-6
    _within_gate_or_f64(name, g, w, tol, None if exact is None else lambda: flat(*exact()))
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
    f64 = lambda t: tuple(u.double() for u in t)
    _check_vjp(got, want, 2e-2 if case == "sigma_bias_5" else 1e-4,
               lambda: tk.fused_render_bwd_reference(x.double(), z.double(), dnorm.double(),
                                                     f64(packed), *f64(cot), white_bkgd=white),
               f"render_bwd[{case}-{H}-{L}-{S}]")
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
        _check_train(got, tt.fused_train_objective_reference(*args, **opts), 1e-4,
                     _objective_f64(args, opts), "script_width_kernels[1]")
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


DP_CONFIG = {
    "data": {"resolution": 24}, "nerf_model": {"sigma_bias": 0.1, "hidden_dim": 128,
                                               "num_layers": 3},
    # 144 rays per view in batches of 100 (ragged tail of 56), then 576 in 256s
    "training": {"phases": [{"start": 0, "end": 1, "H": 12, "n_samples": 32, "batch_size": 100},
                            {"start": 1, "H": 24, "n_samples": 48, "batch_size": 256}]},
    "rendering": {"chunk_size": 256},
}


def _dp_train(mesh, device=None):
    """Epochs 0 and 1 of ``DP_CONFIG`` (jitter on) under ``mesh``, or on
    ``device`` without one: per-step losses, kernel-1 launches, parameters."""
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    tr = Trainer(config_from_dict(DP_CONFIG), data, device=device, mesh=mesh)
    before = tt.fused_train_objective.launches["train_pe"]
    steps = []
    for epoch in (0, 1):
        tr.train_epoch(epoch)
        steps.append(tr.last_step_losses)
    return {"steps": steps, "launches": tt.fused_train_objective.launches["train_pe"] - before,
            "params": {k: v.cpu().numpy() for k, v in tr.model.state_dict().items()}}


@pytest.mark.cuda
def test_dp_world_1_nccl_is_bit_equal_to_no_mesh(h100):
    """A one-rank NCCL mesh on the card: its all-reduces are copies, so two
    epochs (jitter on, a masked ragged tail) give the no-mesh trainer's
    per-step losses and parameters bit for bit; one kernel-1 launch per
    step."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh

    want = _dp_train(None, h100)
    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=h100)
    try:
        mesh = pmesh.make_mesh(h100)
        assert (mesh.backend, mesh.world_size, mesh.device) == ("nccl", 1, h100)
        got = _dp_train(mesh)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got["steps"], want["steps"]):
        assert np.array_equal(g, w)
    assert all(np.array_equal(got["params"][k], v) for k, v in want["params"].items())
    n_steps = sum(len(s) for s in want["steps"])
    assert got["launches"] == want["launches"] == n_steps == 2 * 2 + 2 * 3


@pytest.mark.cuda
def test_dp_world_2_gloo_on_one_card(h100):
    """Two ranks on ``cuda:0`` over Gloo (NCCL refuses two ranks on one
    card): per-step losses within rel 1e-4 of the no-mesh trainer (the order
    of the sums differs), both ranks bit-equal in losses and parameters,
    one kernel-1 launch per step per rank."""
    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh

    want = _dp_train(None, h100)
    two = pmesh.launch(_dp_train, ["cuda:0", "cuda:0"], backend="gloo", timeout_s=600)
    for e in (0, 1):
        assert np.array_equal(two[0]["steps"][e], two[1]["steps"][e])
        np.testing.assert_allclose(two[0]["steps"][e], want["steps"][e], rtol=1e-4)
    assert all(np.array_equal(two[0]["params"][k], two[1]["params"][k]) for k in want["params"])
    assert two[0]["launches"] == two[1]["launches"] == want["launches"]


SYNC_KINDS = {"baseline": {}, "hierarchical": {"rendering": {"n_importance": 16}},
              "lora": {"nerf_model": {"lora_rank": 4}},
              "dino": {"model": {"use_dino": True, "dino_model_type": "single_scale"}},
              "clip": {"optimizer": {"grad_clip": 0.05}}, "dp_world_1": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SYNC_KINDS))
def test_epoch_steps_and_render_views_make_no_synchronization(h100, kind):
    """A phase-1 epoch's steps (``Trainer.epoch_steps``, jitter on, a masked
    ragged tail) and a ``render_views_device`` call of two views run under
    ``torch.cuda.set_sync_debug_mode("error")``: the host never waits for
    the card before the copies that end ``train_epoch`` and
    ``render_views``. The plain trunk, hierarchical sampling, trunk LoRA,
    DINO features (sampled through the sampler kernel at every step and
    chunk), the global-norm clip and a one-rank NCCL mesh; epoch 0 first,
    outside the check (the kernels' first use)."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.render.point_features import sample_point_features
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    d = {k: dict(v) for k, v in DP_CONFIG.items()}
    for k, v in SYNC_KINDS[kind].items():
        d[k] = {**d.get(k, {}), **v}
    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    feats = (np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
             if kind == "dino" else None)
    mesh = None
    if kind == "dp_world_1":
        pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=h100)
        mesh = pmesh.make_mesh(h100)
    try:
        tr = Trainer(config_from_dict(d), data, data, device=None if mesh else h100, mesh=mesh,
                     dino_features=feats)
        assert tr._use_fused()
        tr.train_epoch(0)
        tr.render_views(data.poses[:1])
        tr.phase_data(1)
        before = tt.fused_train_objective.launches["train_pe"]
        sampled = sample_point_features.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = tr.epoch_steps(1)
            views = tr.render_views_device(data.poses[:2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert tt.fused_train_objective.launches["train_pe"] - before == 2 * 3
        # the DINO steps and eval chunks sample through the sampler kernel
        chunks = -(-2 * 24 * 24 // DP_CONFIG["rendering"]["chunk_size"])
        assert sample_point_features.launches - sampled == (2 * 3 + chunks if feats is not None
                                                            else 0)
        # a one-rank NCCL mesh graphs its step too, the all-reduce inside
        assert tr.step_mode == "graph", tr.step_mode_reason
        assert losses.shape == (6,) and torch.isfinite(losses).all()
        assert views[0].shape == (2, 24, 24, 3) and all(torch.isfinite(v).all() for v in views)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


# ---------------------------------------------- the Adam kernel and the graph

# (kind, weight decay, global-norm clip) of the Adam kernel's gate
ADAM_CASES = {"adam_wd1e-6": ("adam", 1e-6, 0.0), "adam_wd0": ("adam", 0.0, 0.0),
              "adam_wd1e-6_clip": ("adam", 1e-6, 1.0), "adam_wd0_clip": ("adam", 0.0, 1.0),
              "adamw_wd1e-6": ("adamw", 1e-6, 0.0)}


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_kernel_is_bit_equal_to_foreach_adam(h100, case):
    """``AdamKernel`` (``csrc/adam.cu``, one launch a step) against
    ``torch.optim.Adam(foreach=True)`` (``AdamW`` for ``adamw``) over 200
    steps across three lr milestones, with and without weight decay and the
    clip (``chip_smoke.adam_steps``: the baseline's parameters, gradients at
    scales over three decades): parameters, both moments and the step count
    bit-equal."""
    from nerf_fewshot_tpu_torch.training.optim import AdamKernel

    import chip_smoke

    kind, wd, clip = ADAM_CASES[case]
    before = AdamKernel.launches
    got = chip_smoke.adam_steps(h100, kind, wd, clip, kernel=True)
    assert AdamKernel.launches - before == 200
    want = chip_smoke.adam_steps(h100, kind, wd, clip, kernel=False)
    torch.cuda.synchronize()
    for p, q in zip(got.param_groups[0]["params"], want.param_groups[0]["params"]):
        assert _same_bits(p.detach(), q.detach())
        for key in ("exp_avg", "exp_avg_sq"):
            assert _same_bits(got.state[p][key], want.state[q][key]), key
        assert float(got.state[p]["step"]) == float(want.state[q]["step"]) == 200.0


GRAPH_KINDS = {"baseline": {}, "hierarchical": {"rendering": {"n_importance": 16}},
               "lora": {"nerf_model": {"lora_rank": 4}, "optimizer": {"lora_only_after_epoch": 2}},
               # past one launch's 32 layers: each LoRA pack kernel twice a step
               "lora_l40": {"nerf_model": {"lora_rank": 4, "num_layers": 40},
                            "optimizer": {"lora_only_after_epoch": 2}},
               # the merge's float64 sums above rank 1020
               "lora_r1024": {"nerf_model": {"lora_rank": 1024},
                              "optimizer": {"lora_only_after_epoch": 2}},
               "dino": {"model": {"use_dino": True, "dino_model_type": "single_scale"}},
               "clip": {"optimizer": {"grad_clip": 0.05}},
               "bfloat16": {"rendering": {"compute_dtype": "bfloat16"}},
               "highest": {"rendering": {"compute_dtype": "highest"}}}


def _graph_trainer(kind, device, eager):
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    d = {k: dict(v) for k, v in DP_CONFIG.items()}
    for k, v in GRAPH_KINDS[kind].items():
        d[k] = {**d.get(k, {}), **v}
    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    feats = (np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
             if kind == "dino" else None)
    return Trainer(config_from_dict(d), data, data, device=device, dino_features=feats,
                   _eager_step=eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(GRAPH_KINDS))
def test_graphed_epochs_are_bit_equal_to_the_eager_step(h100, kind):
    """Epochs 0-3 (two phases, jitter on, ragged tails; the LoRA trunk
    across its freeze at epoch 2) as CUDA graph replays and through the
    card's eager step (``Trainer(_eager_step=True)``): per-step losses,
    parameters, both Adam moments and the step counts bit-equal. The graph
    launches kernel 1 and the Adam kernel once per step (kernel 2 once more
    with hierarchical sampling, the feature sampler's kernel once with DINO
    features, the two LoRA pack kernels ceil(L / 32) times each with a LoRA
    trunk of L layers: 40 layers take two launches), counted per replay;
    each trainer records its step mode and the eager one why."""
    from nerf_fewshot_tpu_torch.training.optim import AdamKernel
    from nerf_fewshot_tpu_torch.training.step_graph import kernel_launch_counts

    # the graphed trainer on the default device, "cuda" with no index, as
    # the CLI makes it
    graph, eager = _graph_trainer(kind, None, False), _graph_trainer(kind, h100, True)
    lora = kind.startswith("lora")
    packs = -(-graph.cfg.nerf.num_layers // 32) if lora else 0
    for epoch in range(4):
        before = kernel_launch_counts()
        got = graph.epoch_steps(epoch)
        after = kernel_launch_counts()
        want = eager.epoch_steps(epoch)
        n = want.shape[0]
        assert _same_bits(got, want), epoch
        assert after["train_pe"] - before["train_pe"] == n
        assert after["adam"] - before["adam"] == n
        assert after["fwd_pe"] - before["fwd_pe"] == (n if kind == "hierarchical" else 0)
        assert after["point_features"] - before["point_features"] == (n if kind == "dino" else 0)
        for k in ("lora_pack", "lora_pack_vjp"):
            assert after[k] - before[k] == n * packs, k
    assert graph.step_mode == "graph" and graph.step_mode_reason is None
    assert eager.step_mode == "eager" and "_eager_step" in eager.step_mode_reason
    assert len(graph.graph_captures) == (3 if lora else 2)
    assert all(c["launches_per_replay"]["adam"] == 1 for c in graph.graph_captures)
    for (k, p), (_, q) in zip(graph.model.named_parameters(), eager.model.named_parameters()):
        assert _same_bits(p.detach(), q.detach()), k
    for p, q in zip(graph.optimizer.param_groups[0]["params"],
                    eager.optimizer.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graph.optimizer.state[p][key].cpu(),
                               eager.optimizer.state[q][key].cpu()), key
    assert AdamKernel.launches > 0


@pytest.mark.cuda
def test_graphed_trainer_recaptures_after_a_load(h100, tmp_path):
    """A graphed trainer saved after epoch 1 and loaded again (the
    optimizer's state tensors replaced) recaptures its graph and trains on
    bit-equal to the eager trainer that did the same."""
    graph, eager = _graph_trainer("baseline", h100, False), _graph_trainer("baseline", h100, True)
    for tr, name in ((graph, "g.ckpt"), (eager, "e.ckpt")):
        tr.train_epoch(0)
        tr.train_epoch(1)
        tr.save(str(tmp_path / name))
        tr.load(str(tmp_path / name))
    captures = len(graph.graph_captures)
    assert _same_bits(graph.epoch_steps(2), eager.epoch_steps(2))
    assert len(graph.graph_captures) == captures + 1
    for (k, p), (_, q) in zip(graph.model.named_parameters(), eager.model.named_parameters()):
        assert _same_bits(p.detach(), q.detach()), k


@pytest.mark.cuda
def test_a_failed_capture_raises(h100, monkeypatch):
    """A body that cannot be captured (here: one that synchronizes) raises
    from ``epoch_steps``; the trainer does not fall back to the eager step."""
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    tr = _graph_trainer("baseline", h100, False)
    orig = Trainer._static_body

    def body(self, st):
        orig(self, st)
        torch.cuda.synchronize()

    monkeypatch.setattr(Trainer, "_static_body", body)
    with pytest.raises(RuntimeError):
        tr.epoch_steps(0)


MESH_GRAPH_KINDS = ("baseline", "dino", "hierarchical", "lora")


def _mesh_graph_trainer(kind, mesh, eager):
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    d = {k: dict(v) for k, v in DP_CONFIG.items()}
    for k, v in GRAPH_KINDS[kind].items():
        d[k] = {**d.get(k, {}), **v}
    data = make_scene_dataset(lego_like_scene(), 2, img_size=24, gt_samples=64, device="cpu")
    feats = (np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
             if kind == "dino" else None)
    return Trainer(config_from_dict(d), data, data, device=None if mesh else "cuda", mesh=mesh,
                   dino_features=feats, _eager_step=eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESH_GRAPH_KINDS)
def test_dp_world_1_nccl_graph_is_bit_equal_to_eager_and_no_mesh(h100, kind):
    """A one-rank NCCL mesh steps as CUDA graph replays, each rank's capture
    holding the all-reduce of the gradient buffer and the loss: epochs 0-3
    (two phases, jitter on, ragged tails; the LoRA trunk across its freeze
    at 2, a recapture) give the eager mesh step's
    (``Trainer(_eager_step=True)``) and the no-mesh graph's per-step losses,
    parameters and both Adam moments bit for bit. One replay launches
    kernel 1, the Adam kernel and the all-reduce once each (kernel 2 once
    more with hierarchical sampling, the sampler once with DINO, the two
    LoRA pack kernels once each with a LoRA trunk), as the counts over the
    epochs show."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.training.step_graph import kernel_launch_counts

    nomesh = _mesh_graph_trainer(kind, None, False)
    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=h100)
    try:
        mesh = pmesh.make_mesh(h100)
        graph, eager = _mesh_graph_trainer(kind, mesh, False), _mesh_graph_trainer(kind, mesh, True)
        for epoch in range(4):
            before = kernel_launch_counts()
            got = graph.epoch_steps(epoch)
            after = kernel_launch_counts()
            want = eager.epoch_steps(epoch)
            ref = nomesh.epoch_steps(epoch)
            n = want.shape[0]
            assert _same_bits(got, want) and _same_bits(got, ref), epoch
            launched = {k: after[k] - before[k] for k in after}
            lora = n if kind == "lora" else 0
            assert launched == {"train_pe": n, "train_x": 0, "adam": n, "allreduce": n,
                                "fwd_pe": n if kind == "hierarchical" else 0, "fwd": 0,
                                "render_bwd": 0, "point_features": n if kind == "dino" else 0,
                                "lora_pack": lora, "lora_pack_vjp": lora}
        assert graph.step_mode == "graph" and graph.step_mode_reason is None
        assert eager.step_mode == "eager" and "_eager_step" in eager.step_mode_reason
        assert len(graph.graph_captures) == (3 if kind == "lora" else 2)
        for c in graph.graph_captures:
            per = c["launches_per_replay"]
            assert (per["train_pe"], per["adam"], per["allreduce"]) == (1, 1, 1), per
        for other in (eager, nomesh):
            for (k, p), (_, q) in zip(graph.model.named_parameters(),
                                      other.model.named_parameters()):
                assert _same_bits(p.detach(), q.detach()), k
            for p, q in zip(graph.optimizer.param_groups[0]["params"],
                            other.optimizer.param_groups[0]["params"]):
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(graph.optimizer.state[p][key].cpu(),
                                       other.optimizer.state[q][key].cpu()), key
    finally:
        dist.destroy_process_group()


class _Cycle:
    def __init__(self):
        self.me = self


def _nccl_graph_in_a_cycle(mesh):
    """One rank of two: an eager in-place all-reduce (it makes the
    communicator), then one captured in a CUDA graph that a reference cycle
    holds, replayed once; the sum the replay left."""
    from nerf_fewshot_tpu_torch.parallel.mesh import all_reduce_sum_

    buf = torch.full((1 << 20,), float(mesh.rank + 1), device=mesh.device)
    all_reduce_sum_(mesh, buf)  # 1 + 2 on both ranks
    holder = _Cycle()
    holder.graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(mesh.device)
    side.wait_stream(torch.cuda.current_stream(mesh.device))
    with torch.cuda.stream(side):
        holder.graph.capture_begin()
        all_reduce_sum_(mesh, buf)
        holder.graph.capture_end()
    torch.cuda.current_stream(mesh.device).wait_stream(side)
    holder.graph.replay()  # 3 + 3
    return float(buf[0].cpu())


@pytest.mark.cuda
def test_dp_world_2_nccl_teardown_with_a_captured_collective_in_a_cycle(h100):
    """Two NCCL ranks, one card each: a rank whose CUDA graph holding an
    all-reduce is left in a reference cycle still leaves the group
    (``parallel.mesh.shutdown`` collects the graph first; NCCL destroys a
    communicator only once every graph that captured one of its collectives
    is gone, and a graphed DINO mesh trainer once sat in such a cycle), so
    ``launch`` returns with both ranks' replayed sums."""
    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one card")
    assert pmesh.launch(_nccl_graph_in_a_cycle, ["cuda:0", "cuda:1"], timeout_s=120) == [6.0, 6.0]


@pytest.mark.cuda
def test_a_failed_capture_on_an_nccl_mesh_raises(h100, monkeypatch):
    """On a one-rank NCCL mesh a body that cannot be captured (here: one
    that synchronizes) raises from ``epoch_steps``; the trainer does not
    step eagerly in its place."""
    import torch.distributed as dist

    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.training.trainer import Trainer

    orig = Trainer._static_body

    def body(self, st):
        orig(self, st)
        torch.cuda.synchronize()

    pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, device=h100)
    try:
        tr = _mesh_graph_trainer("baseline", pmesh.make_mesh(h100), False)
        monkeypatch.setattr(Trainer, "_static_body", body)
        with pytest.raises(RuntimeError):
            tr.epoch_steps(0)
        assert tr.step_mode == "graph"
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- the feature sampler kernel

# chip_smoke's cases at the shipped shapes, plus the kernel's scalar path
# (Fd % 4 != 0) and a view passed as a Python int
SAMPLER_EXTRA = {"fd6_int_view": (1000, (5, 9, 9, 6), "reference", True, "zeros"),
                 "fd13_mean": (999, (5, 7, 11, 13), "reference", False, "mean")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dino_nerf", "lora_nerf_trunk", "multiscale", "script",
                                  "mean", *sorted(SAMPLER_EXTRA)])
def test_point_features_kernel_matches_plain(h100, case):
    """``csrc/point_features.cu`` against its plain version on the card
    (``chip_smoke.check_sampler``): features within 1e-5 of the map's
    largest value, valid equal but at |z| < 1e-6, under ``mean`` the fill
    the kernel's mean, within rel 1e-6 of the plain one or no further from
    float64; a second call bit-equal; one launch counted a call, four with
    the mean."""
    import chip_smoke
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.render import point_features as tpf

    train = make_scene_dataset(lego_like_scene(), 5, img_size=128, seed=0, device="cpu")
    a = chip_smoke.sampler_inputs(case, train.poses, train.focal, 128, h100,
                                  spec=SAMPLER_EXTRA.get(case))
    if case == "fd6_int_view":
        a["view"] = chip_smoke.SAMPLER_VIEW
    before = tpf.sample_point_features.launches
    got = chip_smoke.sampler_call(tpf.sample_point_features_valid, a)
    again = chip_smoke.sampler_call(tpf.sample_point_features_valid, a)
    torch.cuda.synchronize()
    per_call = 4 if a["invalid_fill"] == "mean" else 1
    assert tpf.sample_point_features.launches - before == 2 * per_call
    want = chip_smoke.sampler_call(tpf.point_features_reference, a)
    raw = None
    if a["invalid_fill"] == "mean":
        raw = chip_smoke.sampler_call(tpf.point_features_reference, a, invalid_fill="zeros")[0]
    chip_smoke.check_sampler(case, got, again, want, a, raw)


@pytest.mark.cuda
def test_point_features_mean_on_two_gloo_ranks(h100):
    """``invalid_fill: mean`` on two Gloo ranks on ``cuda:0``, each rank's
    half of the points through the kernel with the per-channel sums
    all-reduced between its launches (``dp_runs.sampler_rank``): the
    concatenated features against the plain version over all the points in
    one process, at ``check_sampler``'s gates; four launches a call on each
    rank."""
    import chip_smoke
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
    from nerf_fewshot_tpu_torch.render import point_features as tpf
    from nerf_fewshot_tpu_torch.tools import dp_runs

    train = make_scene_dataset(lego_like_scene(), 5, img_size=128, seed=0, device="cpu")
    a = chip_smoke.sampler_inputs("mean", train.poses, train.focal, 128, h100)
    want = chip_smoke.sampler_call(tpf.point_features_reference, a)
    raw = chip_smoke.sampler_call(tpf.point_features_reference, a, invalid_fill="zeros")[0]
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in a.items()}
    two = pmesh.launch(dp_runs.sampler_rank, ["cuda:0", "cuda:0"], (host,), backend="gloo",
                       timeout_s=600)
    assert [t["launches"] for t in two] == [8, 8]
    cat = lambda key, i: torch.as_tensor(np.concatenate([t[key][i] for t in two]), device=h100)
    chip_smoke.check_sampler("mean on two ranks", (cat("kernel", 0), cat("kernel", 1)),
                             (cat("again", 0), cat("again", 1)), want, a, raw)
