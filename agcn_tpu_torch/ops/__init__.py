from agcn_tpu_torch.ops.conv import PointwiseConv, TemporalConv
from agcn_tpu_torch.ops.norm import BatchNorm, LayerNorm

__all__ = ["PointwiseConv", "TemporalConv", "BatchNorm", "LayerNorm"]
