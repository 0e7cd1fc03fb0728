"""Training-rate meter (counterpart of ``RateMeter`` in
``nerf_fewshot_tpu/utils/profiling.py``; the JAX profiler hooks have no
counterpart here)."""

from __future__ import annotations

from typing import Optional


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
