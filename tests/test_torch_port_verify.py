"""``render/verify.py``'s kernel gradient gate: training kernel 1 against
plain autograd on identical inputs, a check for the card only.

Without a CUDA device it raises, as the JAX gate raises off the TPU. The
card test (marked ``cuda``, skipped unless an sm_90 card is present,
decided inside the test) asserts ``ok`` in the live-start regime
(``sigma_bias`` 0.1) and with transmittances at the 1e-10 floor (5.0). On
the card, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_verify.py
"""

import pytest
import torch

from nerf_fewshot_tpu_torch.render.verify import GRAD_REL_TOL, kernel_gradient_check


def test_kernel_gradient_check_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA-only gate"):
        kernel_gradient_check()
    assert GRAD_REL_TOL == 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_bias", [0.1, 5.0])
def test_kernel_gradient_check_is_ok_on_the_card(sigma_bias):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip(f"{torch.cuda.get_device_name(0)} is not sm_90")
    got = kernel_gradient_check(sigma_bias=sigma_bias)
    assert got["ok"], got
    assert set(got) == {"ok", "grad_rel_err", "loss_rel_err", "backend"}
