"""Small host-side utilities: checkpointing, logging, image IO, rates."""

from nerf_fewshot_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nerf_fewshot_tpu_torch.utils.logging import JSONLLogger, save_png
from nerf_fewshot_tpu_torch.utils.profiling import RateMeter

__all__ = ["JSONLLogger", "RateMeter", "restore_checkpoint", "save_checkpoint", "save_png"]
