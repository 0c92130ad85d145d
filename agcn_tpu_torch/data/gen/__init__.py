"""Skeleton data preparation (numpy, and the C++ host kernels of
agcn_tpu_torch/native), port of agcn_tpu/data/gen; the CLI is
`python -m agcn_tpu_torch.data.gen`."""

from agcn_tpu_torch.data.gen.preprocess import pre_normalization
from agcn_tpu_torch.data.gen.rotation import (align_rotation,
                                              angle_between,
                                              rotation_matrix)
from agcn_tpu_torch.data.gen.streams import (bone_stream,
                                             generate_streams,
                                             merge_joint_bone,
                                             motion_stream)

__all__ = ["pre_normalization", "align_rotation", "angle_between",
           "rotation_matrix", "bone_stream", "generate_streams",
           "merge_joint_bone", "motion_stream"]
