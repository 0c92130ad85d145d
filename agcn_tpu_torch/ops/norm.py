"""BatchNorm over the trailing channel axis (port of agcn_tpu/ops/norm.py).

Channels-last, like the JAX package: the statistics are per channel of
the last axis. The parameter and buffer names are torch's
(`weight`, `bias`, `running_mean`, `running_var`, `num_batches_tracked`),
so the reference state dicts load strictly. This slice serves, so only the
eval affine exists; train-mode statistics land with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode batch normalization: y = x * a + b with fp32
    a = weight / sqrt(running_var + eps), b = bias - running_mean * a,
    the output in x's dtype (agcn_tpu/ops/norm.py:67-77).

    Attributes:
      scale_init_value: initial weight (the last GCN BN starts at 1e-6,
        reference agcn.py:88).
      identity_at_eval: skip the op at eval (BN-folded weights only).
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 scale_init_value: float = 1.0,
                 identity_at_eval: bool = False):
        super().__init__()
        self.eps = eps
        self.identity_at_eval = identity_at_eval
        self.weight = nn.Parameter(
            torch.full((num_features,), scale_init_value))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm train-mode statistics land with the training "
                "slice; call .eval() on the model to serve")
        if self.identity_at_eval:
            return x
        a = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        b = self.bias.float() - self.running_mean.float() * a
        return (x * a + b).to(x.dtype)
