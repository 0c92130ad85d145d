from agcn_tpu_torch.graph.build import (
    build_adjacency,
    edge2mat,
    normalize_in_degree,
    normalize_symmetric,
    spatial_graph,
)
from agcn_tpu_torch.graph.skeletons import (
    KINETICS_18,
    NTU_RGBD_25,
    OPENPOSE_B25_J15,
    Skeleton,
    available_skeletons,
    get_skeleton,
)

__all__ = [
    "KINETICS_18", "NTU_RGBD_25", "OPENPOSE_B25_J15", "Skeleton",
    "available_skeletons", "get_skeleton", "build_adjacency", "edge2mat",
    "normalize_in_degree", "normalize_symmetric", "spatial_graph",
]
