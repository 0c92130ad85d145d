"""Convolutions for the (B, T, V, C) channels-last layout
(port of agcn_tpu/ops/conv.py).

The reference's temporal units are kx1 Conv2d over (T, V) grids
(reference agcn.py:36-50). A (B, T, V, C) tensor permuted to
(B, C, T, V) is already in torch's channels_last memory format, so
`TemporalConv` hands cuDNN the activation without a copy. A 1x1 conv is a
matmul on the channel axis. Weights keep torch's conv layout
(out, in, kh, kw) so the reference state dicts load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


class PointwiseConv(nn.Module):
    """1x1 convolution == per-position dense projection on channels."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.view(self.weight.shape[0], -1)
        return F.linear(_cast(x, self.dtype), _cast(w, self.dtype),
                        _cast(self.bias, self.dtype))


class TemporalConv(nn.Module):
    """kx1 convolution along time for (B, T, V, C) tensors: kernel (k, 1),
    stride (s, 1), symmetric time padding (k-1)/2 when `pad`
    (agcn_tpu conv.py:64-75)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 9,
                 stride: int = 1, dtype: Optional[torch.dtype] = None,
                 pad: bool = True):
        super().__init__()
        self.stride = stride
        self.pad = (kernel_size - 1) // 2 if pad else 0
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.dtype).permute(0, 3, 1, 2)  # (B, C, T, V) view
        w = _cast(self.weight, self.dtype).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(x, w, _cast(self.bias, self.dtype),
                     stride=(self.stride, 1), padding=(self.pad, 0))
        return y.permute(0, 2, 3, 1).contiguous()
