"""BatchNorm (+ cross-rank sync, + Ghost splits) and LayerNorm over the
trailing channel axis (port of agcn_tpu/ops/norm.py).

Channels-last, like the JAX package: the statistics are per channel of
the last axis. The parameter and buffer names are torch's
(`weight`, `bias`, `running_mean`, `running_var`, `num_batches_tracked`),
so the reference state dicts load strictly. Torch semantics in train
mode: momentum 0.1, the biased batch variance normalizes, the unbiased
one goes into the running statistics.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch import nn

# torch convention: running = (1 - m) * running + m * batch
MOMENTUM = 0.1


class BatchNorm(nn.Module):
    """Batch normalization, y = x * a + b with fp32 per-channel a, b and
    the output in x's dtype (agcn_tpu/ops/norm.py:67-77).

    Train mode normalizes with the batch statistics, computed in fp32
    (also under bf16) as E[x] and E[x^2] - E[x]^2 like the JAX package
    (norm.py:112-127), and folds them into the running statistics; eval
    mode uses the running statistics.

    Attributes:
      scale_init_value: initial weight (the last GCN BN starts at 1e-6,
        reference agcn.py:88).
      identity_at_eval: skip the op at eval (BN-folded weights only).
      splits: Ghost BatchNorm with this many virtual batches when > 1
        (reference ghostbatchnorm.py; 0 and 1 are plain BatchNorm, as in
        the JAX package): in train mode split s normalizes samples
        {s, S+s, 2S+s, ...} with its own statistics, and the running
        statistics take the mean of the splits' (norm.py:82-107).
      axis_name: SyncBN over this axis of the bound mesh
        (parallel/mesh.py; norm.py:109-130): in train mode one all-reduce
        over the axis' ranks of [sum x, sum x^2, count] in fp32 gives the
        statistics of all their rows, and the backward sums the
        statistics' gradient over the ranks (JAX's psum). Ghost BN does
        not sync, as in the JAX package. Train mode without a bound mesh
        raises JAX's NameError for an unbound axis; eval mode does not
        need one. The trainer sets it on every BatchNorm of a
        data-parallel run.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 scale_init_value: float = 1.0,
                 identity_at_eval: bool = False, splits: int = 1,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.eps = eps
        self.splits = splits
        self.identity_at_eval = identity_at_eval
        # set while a checkpointed block recomputes its forward for the
        # backward: that pass must not update the running statistics again
        self.recomputing = False
        self.weight = nn.Parameter(
            torch.full((num_features,), scale_init_value))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def _affine(self, x: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor) -> torch.Tensor:
        a = self.weight.float() * torch.rsqrt(var + self.eps)
        b = self.bias.float() - mean * a
        return (x * a + b).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.identity_at_eval:
                return x
            return self._affine(x, self.running_mean.float(),
                                self.running_var.float())
        if self.splits > 1:
            return self._ghost(x)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        if self.axis_name is None:
            mean = xf.mean(dim=dims)
            var = (xf * xf).mean(dim=dims) - mean * mean
            count = x.numel() // x.shape[-1]
        else:
            mean, var, count = self._synced_stats(xf, dims)
        self._track(mean, var, count)
        return self._affine(x, mean, var)

    def _synced_stats(self, xf: torch.Tensor, dims):
        """(mean, biased var, count) over the rows of every rank of the
        axis (norm.py:116-127)."""
        from agcn_tpu_torch.parallel.collectives import psum
        from agcn_tpu_torch.parallel.mesh import axis_group

        group = axis_group(self.axis_name)
        c = xf.shape[-1]
        total = psum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                                xf.new_full((1,), xf.numel() // c)]), group)
        count = total[-1]
        mean = total[:c] / count
        return mean, total[c:-1] / count - mean * mean, count

    def _track(self, mean: torch.Tensor, var: torch.Tensor,
               count) -> None:
        """Fold batch statistics into the running ones (not while a
        checkpointed block recomputes its forward)."""
        if self.recomputing:
            return
        m = MOMENTUM
        with torch.no_grad():
            unbiased = var * count / (torch.clamp(count - 1, min=1)
                                      if torch.is_tensor(count)
                                      else max(count - 1, 1))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked.add_(1)

    def _ghost(self, x: torch.Tensor) -> torch.Tensor:
        """Ghost BatchNorm in train mode, in fp32 (norm.py:82-107, 141)."""
        n, c, s = x.shape[0], x.shape[-1], self.splits
        if n % s:
            raise ValueError(f"batch {n} not divisible by gbn splits {s}")
        xs = x.float().reshape((n // s, s) + tuple(x.shape[1:]))
        dims = (0,) + tuple(range(2, xs.dim() - 1))
        mean_s = xs.mean(dim=dims)  # (S, C)
        var_s = (xs * xs).mean(dim=dims) - mean_s * mean_s
        shape = (1, s) + (1,) * (x.dim() - 2) + (c,)
        y = (xs - mean_s.reshape(shape)) * torch.rsqrt(
            var_s.reshape(shape) + self.eps)
        self._track(mean_s.mean(dim=0), var_s.mean(dim=0),
                    xs.numel() // (s * c))
        y = y.reshape(x.shape) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis (agcn_tpu/ops/norm.py:144-157;
    torch nn.LayerNorm semantics and names)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


@contextlib.contextmanager
def recomputing(module: nn.Module) -> Iterator[None]:
    """Mark every BatchNorm under `module` as recomputing for the scope,
    so that no forward in it moves the running statistics (the recompute
    context of `torch.utils.checkpoint`, and SAM's second pass); the
    marks in force before it come back after it, so scopes nest."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.recomputing for m in norms]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.recomputing = flag


def sync_batch_norms(module: nn.Module, axis_name: Optional[str]) -> None:
    """Set `axis_name` on every BatchNorm under `module` (the models'
    `sync_axis`, and the trainer's data axis)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = axis_name
