"""Pure tensor ops: rays, sampling, encoding, compositing."""

from nerf_fewshot_tpu_torch.ops.composite import (
    RenderOutputs,
    composite_rays,
    compute_weights,
    volume_render,
)
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding, posenc_output_dim
from nerf_fewshot_tpu_torch.ops.rays import get_rays
from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays, sample_pdf

__all__ = [
    "RenderOutputs",
    "composite_rays",
    "compute_weights",
    "get_rays",
    "hierarchical_sample",
    "positional_encoding",
    "posenc_output_dim",
    "sample_along_rays",
    "sample_pdf",
    "volume_render",
]
