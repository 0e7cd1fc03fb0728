"""Profiling and debugging hooks (counterpart of
``nerf_fewshot_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a
block written as a Chrome trace, the rays/s meter, and the NaN guard as
autograd's anomaly mode. The JAX compile cache has no counterpart."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block (the CPU, and the CUDA activity when a
    card is present) and write ``<log_dir>/trace.json`` (open it in
    Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RateMeter:
    """Exponentially-smoothed rays/s meter for the training loop."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate: Optional[float] = None

    def update(self, n_rays: int, seconds: float) -> float:
        """Fold an explicitly timed interval into the average (the trainer
        times the train phase only, so eval and checkpoint time between
        epochs do not enter the rate)."""
        inst = n_rays / max(seconds, 1e-9)
        self.rate = inst if self.rate is None else self.alpha * inst + (1 - self.alpha) * self.rate
        return self.rate


def enable_nan_guard(enable: bool = True) -> None:
    """Make autograd raise at the operation whose backward produced a NaN,
    with the forward's stack (``torch.autograd.set_detect_anomaly``): the
    counterpart of ``jax_debug_nans``. It covers the plain path's autograd;
    the kernels' gradients are computed inside the kernel, outside its
    reach."""
    torch.autograd.set_detect_anomaly(enable)
