from selfpose3d_tpu_torch.ops.gaussian import render_gaussian_heatmaps
from selfpose3d_tpu_torch.ops.proposal import (
    max_pool_nms_3d,
    nms_topk,
    proposals_soft,
    voxel_index_to_world,
)
from selfpose3d_tpu_torch.ops.sampling import bilinear_sample
from selfpose3d_tpu_torch.ops.slicewarp import (
    LAUNCHES,
    reset_launches,
    sample_view,
    sample_view_plain,
    sample_views_mean,
    sample_views_mean_plain,
)
from selfpose3d_tpu_torch.ops.softargmax import soft_argmax_ndhwc
from selfpose3d_tpu_torch.ops.unproject import (
    compute_sample_grid,
    sample_cubes,
    to_pixels,
    unproject_heatmaps,
)

__all__ = [
    "render_gaussian_heatmaps",
    "max_pool_nms_3d",
    "nms_topk",
    "proposals_soft",
    "voxel_index_to_world",
    "bilinear_sample",
    "LAUNCHES",
    "reset_launches",
    "sample_view",
    "sample_view_plain",
    "sample_views_mean",
    "sample_views_mean_plain",
    "soft_argmax_ndhwc",
    "compute_sample_grid",
    "sample_cubes",
    "to_pixels",
    "unproject_heatmaps",
]
