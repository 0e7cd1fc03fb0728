"""Find, operation by operation, how torch's foreach Adam rounds on this
card: which of its foreach kernels contract a multiply and an add into one
FMA. ``csrc/adam.cu`` writes each operation with explicit roundings
(``__fmaf_rn``, ``__fmul_rn``, ``__fadd_rn``, ...) chosen to match.

    python nerf_fewshot_tpu_torch/tools/adam_bits.py [--n 4000000] [--seed 0]

For every foreach call that ``torch.optim.Adam(foreach=True)`` (and
``AdamW``) makes in a step, in the order it makes them, the script draws
fp32 operands with Adam's magnitudes (gradients, moments and parameters
over eight decades), runs torch's call on the card, and counts the
elements where each candidate rounding differs from it. A candidate is
computed on the card in float64 and rounded to fp32 once per fp32
operation it stands for: an FMA is ``fp32(a * b + c)`` from the exact
product (the float64 sum rounds twice only at ties, one in ~2^29), a
separate multiply and add round after each. The per-tensor ops (the
foreach fallback that transposed gradients take) are counted beside the
foreach kernels. It prints one line per operation and, last, a JSON
object of the counts; a candidate with 0 mismatches is the kernel's
rounding. Scalars are cast to fp32 as torch casts a Python scalar for its
foreach kernels.
"""

from __future__ import annotations

import argparse
import json

BETA1, BETA2, EPS, WD, LR = 0.9, 0.999, 1e-8, 1e-6, 5e-4


def _operands(n: int, seed: int, device):
    import torch

    g = torch.Generator(device).manual_seed(seed)

    def draw(lo, hi):
        scale = 10.0 ** (torch.rand(n, generator=g, device=device, dtype=torch.float64)
                          * (hi - lo) + lo)
        return (torch.randn(n, generator=g, device=device, dtype=torch.float64) * scale).float()

    return dict(p=draw(-3, 0), g=draw(-8, 0), m=draw(-9, -1), v=draw(-14, -2).abs(),
                d=draw(-7, -2).abs() + 1e-8)


def _f32(x):
    return x.float()


def _d(x):
    import torch

    return x.to(torch.float64) if torch.is_tensor(x) else x


def probe(n: int = 4_000_000, seed: int = 0) -> dict:
    """The mismatch counts of every candidate rounding of every operation,
    by operation name."""
    import torch

    dev = torch.device("cuda", 0)
    x = _operands(n, seed, dev)
    p, g, m, v, d = x["p"], x["g"], x["m"], x["v"], x["d"]
    s = lambda c: torch.tensor(c, dtype=torch.float32).item()  # torch's cast of a scalar
    w1, b2, vs, eps, wd = s(1 - BETA1), s(BETA2), s(1 - BETA2), s(EPS), s(WD)
    step_size, bc2 = s(-(LR / (1 - BETA1 ** 3))), s((1 - BETA2 ** 3) ** 0.5)
    decay = s(1 - LR * WD)
    fma = lambda a, b, c: _f32(_d(a) * _d(b) + _d(c))
    out = {}

    def count(name, got, **cands):
        got = got.view(torch.int32)
        out[name] = {k: int((c.view(torch.int32) != got).sum()) for k, c in cands.items()}
        print(f"{name}: " + ", ".join(f"{k} {c} mismatches" for k, c in out[name].items()),
              flush=True)

    # weight decay: grads + wd * params (alpha)
    sep_wd = _f32(_d(g) + _d(_f32(_d(wd) * _d(p))))
    count("foreach_add_alpha", torch._foreach_add([g], [p], alpha=WD)[0],
          fma=fma(wd, p, g), separate=sep_wd)
    count("add_alpha", torch.add(g, p, alpha=WD), fma=fma(wd, p, g), separate=sep_wd)
    # exp_avg.lerp_(grad, 1 - beta1): m + w * (g - m)
    diff = _f32(_d(g) - _d(m))
    cands = dict(fma=fma(w1, diff, m), separate=_f32(_d(m) + _d(_f32(_d(w1) * _d(diff)))),
                 two_fma=fma(w1, g, fma(-w1, m, m)))
    t = m.clone()
    torch._foreach_lerp_([t], [g], 1 - BETA1)
    count("foreach_lerp", t, **cands)
    count("lerp", torch.lerp(m, g, 1 - BETA1), **cands)
    # exp_avg_sq.mul_(beta2)
    t = v.clone()
    torch._foreach_mul_([t], BETA2)
    count("foreach_mul", t, exact=_f32(_d(v) * _d(b2)))
    # exp_avg_sq.addcmul_(grad, grad, 1 - beta2): v + vs * (g * g)
    gg = _f32(_d(g) * _d(g))
    cands = dict(fma_of_square=fma(vs, gg, v), separate=_f32(_d(v) + _d(_f32(_d(vs) * _d(gg)))),
                 fma_of_scaled=fma(_f32(_d(vs) * _d(g)), g, v))
    t = v.clone()
    torch._foreach_addcmul_([t], [g], [g], 1 - BETA2)
    count("foreach_addcmul", t, **cands)
    count("addcmul", torch.addcmul(v, g, g, value=1 - BETA2), **cands)
    # denom = sqrt(exp_avg_sq) / bias_correction2_sqrt + eps
    count("foreach_sqrt", torch._foreach_sqrt([v])[0], exact=_f32(torch.sqrt(_d(v))))
    t = d.clone()
    torch._foreach_div_([t], [(1 - BETA2 ** 3) ** 0.5])
    count("foreach_div_scalarlist", t, exact=_f32(_d(d) / _d(bc2)),
          reciprocal=_f32(_d(d) * s(1.0 / bc2)))
    t = d.clone()
    torch._foreach_add_([t], EPS)
    count("foreach_add_scalar", t, exact=_f32(_d(d) + _d(eps)))
    # params.addcdiv_(exp_avg, denom, step_size): p + s * (m / d)
    q = _f32(_d(m) / _d(d))
    cands = dict(fma_of_quotient=fma(step_size, q, p),
                 separate=_f32(_d(p) + _d(_f32(_d(step_size) * _d(q)))),
                 scaled_numerator=_f32(_d(p) + _d(_f32(_d(_f32(_d(step_size) * _d(m))) / _d(d)))))
    t = p.clone()
    torch._foreach_addcdiv_([t], [m], [d], [-(LR / (1 - BETA1 ** 3))])
    count("foreach_addcdiv_scalarlist", t, **cands)
    count("addcdiv", torch.addcdiv(p, m, d, value=-(LR / (1 - BETA1 ** 3))), **cands)
    # AdamW: params.mul_(1 - lr * wd)
    t = p.clone()
    torch._foreach_mul_([t], 1 - LR * WD)
    count("foreach_mul_decay", t, exact=_f32(_d(p) * _d(decay)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("adam_bits: no CUDA device")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0), "n": args.n,
                      "mismatches": probe(args.n, args.seed)}), flush=True)


if __name__ == "__main__":
    main()
