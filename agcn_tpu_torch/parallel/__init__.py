"""Data-parallel and edge-partitioned training (port of agcn_tpu/parallel:
mesh.py and edge_partition.py)."""

from agcn_tpu_torch.parallel.mesh import (
    Mesh,
    axis_group,
    destroy,
    gather_rows,
    init_distributed,
    interleave,
    is_main,
    make_mesh,
)

__all__ = ["Mesh", "axis_group", "destroy", "gather_rows",
           "init_distributed", "interleave", "is_main", "make_mesh"]
