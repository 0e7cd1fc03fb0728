"""Pure tensor ops: rays, projections, interpolation, sampling, encoding,
compositing."""

from nerf_fewshot_tpu_torch.ops.composite import (
    RenderOutputs,
    composite_rays,
    compute_weights,
    volume_render,
)
from nerf_fewshot_tpu_torch.ops.encoding import positional_encoding, posenc_output_dim
from nerf_fewshot_tpu_torch.ops.interp import grid_sample, resize_bilinear
from nerf_fewshot_tpu_torch.ops.rays import get_rays, project_points_script, project_points_to_image
from nerf_fewshot_tpu_torch.ops.sampling import hierarchical_sample, sample_along_rays, sample_pdf

__all__ = [
    "RenderOutputs",
    "composite_rays",
    "compute_weights",
    "get_rays",
    "grid_sample",
    "hierarchical_sample",
    "positional_encoding",
    "posenc_output_dim",
    "project_points_script",
    "project_points_to_image",
    "resize_bilinear",
    "sample_along_rays",
    "sample_pdf",
    "volume_render",
]
