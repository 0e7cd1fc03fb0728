"""CPU rehearsal of the numerics of ``csrc/train_pe.cu`` and ``csrc/fwd_pe.cu``:
the trunk products of the training objective (kernels 1 and 5), of the
render VJP (kernel 3) and of the render forward (kernels 2 and 4) run there
as 3xTF32 on the tensor cores. This file emulates that split in plain torch
and holds the emulated objective, VJP and render against the exact fp32
plain versions at the gates the card tests use.

The emulation: TF32 rounding as ``cvt.rna.tf32.f32`` does it (round to
nearest on the 13 dropped mantissa bits, ties away from zero), by integer
operations on the fp32 bits; each operand cut into hi = rna(v) and
lo = rna(v - hi); a product as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in
fp32 in that order. It replaces every trunk product of
``fused_train_objective_reference`` (the forward layers, and through autograd
the backward chain and the dW products), of ``fused_render_bwd_reference``
(the same, and dx) and of ``fused_render_fwd_pe_reference`` /
``fused_render_reference`` (the forward layers). The products with the
head's four live columns (the head, the seed of the backward chain and dW
of the head) stay exact: the kernels run the first two in exact fp32 on the
CUDA cores; the third, 0.4 % of the dW work, kernels 1, 5 and 3 run as
3xTF32, which this emulation leaves out. The emulation does not model the
tensor cores' accumulation order or rounding (the kernels add the products
of every 32 weight rows of the trunk and every 32-point stage of the dW
products (``train_pe.cu``) or of every 32-row weight stage
(``fwd_pe.cu``) into the running sum with round-to-nearest FADDs). Nothing
in the package uses it.

Gates (the card's): loss rel 1e-5; the six packed gradients (and dx) as one
vector rel 1e-4, and 2e-2 at sigma_bias 5.0, where the backward divides by
transmittances at the 1e-10 floor; the render's rgb, acc and weights 1e-4
and depth 1e-3 (max abs). Full width: 8x256 trunk, pos_freq 10, dir_freq 4,
on a few hundred points; the render also at pos_freq 12 with 64-wide
features (D 176) and from a 128-wide encoded x; the objective and the render
at the script recipes' width (pos_freq 10, view directions, 768 features:
D 864), where layer 0 sums 858 terms and is a third of the forward's work.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt

R, S, H, L = 12, 32, 256, 8  # 384 points through the baseline trunk


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32, summed in fp32: the small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


class _SplitMM(torch.autograd.Function):
    """A trunk product whose forward and both backward products are 3xTF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm3(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return mm3(g, b.T), mm3(a.T, g)


class Emulate3xTF32(TorchFunctionMode):
    """Runs every 2-D ``@`` / ``matmul`` whose inner and outer widths both
    differ from 4 (the head's live columns) through ``_SplitMM``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__) and not kwargs:
            a, b = args
            if a.dim() == 2 and b.dim() == 2 and 4 not in (a.shape[1], b.shape[1]):
                return _SplitMM.apply(a, b)
        return func(*args, **kwargs)


def _rel(got, want):
    g = torch.cat([t.reshape(-1).double() for t in got])
    w = torch.cat([t.reshape(-1).double() for t in want])
    return ((g - w).norm() / w.norm()).item(), w.norm().item()


def test_hi_plus_lo_reproduces_fp32():
    """Normal fp32 values whose halves stay normal (|v| in 1e-30 .. 1e30)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(np.concatenate([
        rng.standard_normal(100_000) * 10.0 ** rng.uniform(-30, 30, 100_000),
        [1.0, -1.0, 1.0 + 2.0 ** -23, 3.0 * 2.0 ** -14, 65504.0]]).astype(np.float32))
    hi, lo = split(x)
    for h in (hi, lo):  # both halves are TF32 values: 13 low bits clear
        assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    xd = x.double()
    err = (xd - (hi.double() + lo.double())).abs()
    assert (err <= 2.0 ** -21 * xd.abs()).all()
    assert (tf32_rna(hi) == hi).all()
    # ties go away from zero, as cvt.rna.tf32.f32
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_emulation_reaches_every_trunk_product():
    """Under the mode, the trunk's forward product is the 3xTF32 one, and a
    head-width product stays exact."""
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((256, 256)).astype(np.float32))
    head = torch.tensor(rng.standard_normal((256, 4)).astype(np.float32))
    with Emulate3xTF32():
        assert torch.equal(a @ b, mm3(a, b))
        assert torch.equal(a @ head, torch.matmul(a, head).clone())
    assert not torch.equal(mm3(a, b), a @ b)


OBJECTIVE_CASES = {
    "baseline": ({}, 1e-4),
    "white_masked_reg_depth_feats": (dict(white_bkgd=True, ragged=2, reg_weight=0.01,
                                          depth_weight=0.1, feat_dim=64), 1e-4),
    "x_input": (dict(inline_pe=False), 1e-4),
    "sigma_bias_5": (dict(sigma_bias=5.0), 2e-2),
    # kernel 1 at the script recipes' width: 90 + 768 columns, D 864
    "script_feats_d864": (dict(feat_dim=768), 1e-4),
}


@pytest.mark.parametrize("case", sorted(OBJECTIVE_CASES))
def test_emulated_objective_meets_the_card_gates(case):
    import chip_smoke

    kw, grad_tol = OBJECTIVE_CASES[case]
    args, opts = chip_smoke.random_train_args(np.random.default_rng(0), R, S, H, L, "cpu", **kw)
    assert args[-1][0].shape[0] == tk.pe_width(90 + kw.get("feat_dim", 0)) or not opts["inline_pe"]
    want_loss, want = tt.fused_train_objective_reference(*args, **opts)
    with Emulate3xTF32():
        got_loss, got = tt.fused_train_objective_reference(*args, **opts)
    assert torch.isfinite(got_loss) and all(torch.isfinite(g).all() for g in got)
    assert abs(got_loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    rel, norm = _rel(got, want)
    assert norm > 1e-6
    assert rel <= grad_tol, rel
    assert rel > 0.0  # the emulation did change the products


RENDER_CASES = {"baseline": ({}, False, 1e-4), "white_feats": (dict(feat_dim=64), True, 1e-4),
                "sigma_bias_5": (dict(sigma_bias=5.0), False, 2e-2)}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_emulated_render_vjp_meets_the_card_gates(case):
    import chip_smoke

    kw, white, tol = RENDER_CASES[case]
    rng = np.random.default_rng(0)
    args, _ = chip_smoke.random_render_args(rng, R, S, H, L, "cpu", **kw)
    cot = chip_smoke.random_cotangents(rng, R, S, "cpu")
    want = tk.fused_render_bwd_reference(*args, *cot, white_bkgd=white)
    with Emulate3xTF32():
        got = tk.fused_render_bwd_reference(*args, *cot, white_bkgd=white)
    rel, norm = _rel((got[0], *got[1]), (want[0], *want[1]))
    assert norm > 1e-6
    assert rel <= tol, rel
    assert rel > 0.0


FORWARD_CASES = {
    # kernel 2 at the baseline widths (D 96), white background
    "k2_baseline_white": (2, dict(pos_freq=10, feat_dim=0, d=96), True),
    # kernel 2 at a DINO config's widths: pos_freq 12, 64 features, D 176
    "k2_dino_d176": (2, dict(pos_freq=12, feat_dim=64, d=176), False),
    # kernel 2 at the script recipes' width: pos_freq 10, 768 features, D 864
    "k2_script_d864": (2, dict(pos_freq=10, feat_dim=768, d=864), False),
    # kernel 4 from the 128-wide encoded x of pos_freq 10
    "k4_x128": (4, {}, False),
}
RENDER_TOL = {"rgb": 1e-4, "depth": 1e-3, "acc": 1e-4, "weights": 1e-4}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_emulated_render_forward_meets_the_card_gates(case):
    import chip_smoke

    kernel, kw, white = FORWARD_CASES[case]
    rng = np.random.default_rng(0)
    if kernel == 2:
        x_dim = 6 + 6 * kw["pos_freq"] + 24 + kw["feat_dim"]
        args = chip_smoke.random_fwd_pe_args(rng, R, S, H, L, kw["feat_dim"], "cpu",
                                             pos_freq=kw["pos_freq"], d_pad=tk.pe_width(x_dim))
        assert args[-1][0].shape[0] == kw["d"]
        opts = dict(white_bkgd=white, use_feats=kw["feat_dim"] > 0)
        ref = tk.fused_render_fwd_pe_reference
    else:
        args, _ = chip_smoke.random_render_args(rng, R, S, H, L, "cpu")
        assert args[0].shape[1] == 128
        opts = dict(white_bkgd=white)
        ref = tk.fused_render_reference
    want = ref(*args, **opts)
    with Emulate3xTF32():
        got = ref(*args, **opts)
    worst = 0.0
    for g, w, name in zip(got, want, ("rgb", "depth", "acc", "weights")):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= RENDER_TOL[name], (name, err)
        worst = max(worst, err)
    assert worst > 0.0  # the emulation did change the products
