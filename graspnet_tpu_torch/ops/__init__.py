"""Point-cloud ops: sampling, queries, grouping, 3-NN interpolation."""

from graspnet_tpu_torch.ops.query import (
    cylinder_query_multi_depth,
    group_points,
    select_first_hits,
)
from graspnet_tpu_torch.ops.knn import three_interpolate, three_nn
from graspnet_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from graspnet_tpu_torch.ops.cuda.query import ball_query

__all__ = [
    "ball_query",
    "cylinder_query_multi_depth",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "select_first_hits",
    "three_interpolate",
    "three_nn",
]
