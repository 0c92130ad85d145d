"""Auxiliary layer blocks: ASPP, BiFPN, series decomposition (port of
agcn_tpu/ops/blocks.py).

Parity targets: reference model/layers/module/aspp.py (atrous spatial
pyramid pooling over time), bifpn.py (EfficientDet-style weighted
bidirectional FPN over the 3 GCN feature levels),
series_decomposition.py (Autoformer moving-average trend/seasonal split).
All operate on (B, T, V, C) channels-last tensors.

The JAX package's torch export has no names for these blocks, so the
module and parameter names are the JAX modules' (`branch_1x1`, `bn_1x1`,
`branch_d{d}`, `in_proj{i}`, `w_td`, `td{i}_bn`, ...): a flax Dense is an
`nn.Linear` (weight (out, in)), the dilated time conv an `nn.Conv2d` over
(B, C, T, V) (weight (out, in, k, 1)), and the BatchNorms the port's
channels-last `BatchNorm`. The ReLUs call `torch.relu` in the JAX
blocks' order (the calls tools/grad_parity.py's probe replays).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import BatchNorm


def _dense(in_features: int, out_features: int, bias: bool) -> nn.Linear:
    # skip_init: nn.Linear's own init would draw from the global RNG
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              bias=bias)


def _kaiming(layer: nn.Module, generator: torch.Generator) -> None:
    """flax's kaiming_normal_fan_out kernel and zero bias."""
    init.kaiming_normal_fan_out(layer.weight, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def moving_average(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The mean of each `kernel_size` window along time (axis 1), the ends
    replicated ((k - 1) // 2 frames in front, the rest behind), by
    cumulative sums, as the JAX package computes it."""
    k = kernel_size
    front = (k - 1) // 2
    padded = torch.cat([x[:, :1].expand(-1, front, *x.shape[2:]), x,
                        x[:, -1:].expand(-1, k - 1 - front, *x.shape[2:])],
                       dim=1)
    cs = torch.cumsum(padded, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    return (cs[:, k:] - cs[:, :-k]) / k


class ASPP(nn.Module):
    """Atrous pyramid over the time axis (agcn_tpu blocks.py:21-57): a 1x1
    branch, one (k x 1) conv a dilation d (k = 1 at d = 1, else 3, "SAME"
    padding d (k - 1) / 2 on time), each -> BN -> relu; a global-mean
    branch over time (no BN) broadcast back over T; concatenated, then
    projected -> BN -> relu."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 3, 5),
                 use_bias: bool = False):
        super().__init__()
        self.dilations = tuple(int(d) for d in dilations)
        self.branch_1x1 = _dense(in_channels, out_channels, use_bias)
        self.bn_1x1 = BatchNorm(out_channels)
        for d in self.dilations:
            k = 1 if d == 1 else 3
            self.add_module(f"branch_d{d}", nn.utils.skip_init(
                nn.Conv2d, in_channels, out_channels, (k, 1),
                dilation=(d, 1), padding=(d * (k - 1) // 2, 0),
                bias=use_bias))
            self.add_module(f"bn_d{d}", BatchNorm(out_channels))
        self.branch_pool = _dense(in_channels, out_channels, use_bias)
        self.project = _dense(out_channels * (len(self.dilations) + 2),
                              out_channels, use_bias)
        self.bn_out = BatchNorm(out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _kaiming(self.branch_1x1, generator)
        for d in self.dilations:
            _kaiming(getattr(self, f"branch_d{d}"), generator)
        _kaiming(self.branch_pool, generator)
        _kaiming(self.project, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [torch.relu(self.bn_1x1(self.branch_1x1(x)))]
        xc = x.permute(0, 3, 1, 2)  # (B, C, T, V)
        for d in self.dilations:
            y = getattr(self, f"branch_d{d}")(xc).permute(0, 2, 3, 1)
            branches.append(torch.relu(getattr(self, f"bn_d{d}")(y)))
        g = torch.relu(self.branch_pool(x.mean(dim=1, keepdim=True)))
        branches.append(g.expand(-1, x.shape[1], -1, -1))
        y = self.project(torch.cat(branches, dim=-1))
        return torch.relu(self.bn_out(y))


class BiFPNBlock(nn.Module):
    """One weighted bidirectional fusion pass over `num_levels` levels of
    width `dim` (agcn_tpu blocks.py:60-95): `w_td` (L - 1, 2) and `w_bu`
    (L - 1, 3), ones at init, each row relu'd and divided by its sum +
    eps; the fused levels through `td{i}` / `bu{i}` (bias-free Linear ->
    BN `td{i}_bn` / `bu{i}_bn` -> relu)."""

    def __init__(self, dim: int, num_levels: int = 3, eps: float = 1e-4):
        super().__init__()
        self.num_levels = n = num_levels
        self.eps = eps
        self.w_td = nn.Parameter(torch.ones(n - 1, 2))
        self.w_bu = nn.Parameter(torch.ones(n - 1, 3))
        for name in ([f"td{i}" for i in range(n - 2, -1, -1)]
                     + [f"bu{i}" for i in range(1, n)]):
            self.add_module(name, _dense(dim, dim, False))
            self.add_module(f"{name}_bn", BatchNorm(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.w_td.fill_(1.0)
            self.w_bu.fill_(1.0)
        for i in range(self.num_levels - 2, -1, -1):
            _kaiming(getattr(self, f"td{i}"), generator)
        for i in range(1, self.num_levels):
            _kaiming(getattr(self, f"bu{i}"), generator)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f"{name}_bn")(
            getattr(self, name)(x)))

    def _weights(self, row: torch.Tensor) -> torch.Tensor:
        w = torch.relu(row)
        return w / (w.sum() + self.eps)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.num_levels
        td = list(feats)  # top-down; td[-1] is the top level itself
        for i in range(n - 2, -1, -1):
            w = self._weights(self.w_td[i])
            td[i] = self._conv(f"td{i}", w[0] * feats[i] + w[1] * td[i + 1])
        out = [td[0]]  # bottom-up
        for i in range(1, n):
            w = self._weights(self.w_bu[i - 1])
            out.append(self._conv(
                f"bu{i}", w[0] * feats[i] + w[1] * td[i] + w[2] * out[-1]))
        return out


class BiFPN(nn.Module):
    """Each level projected to `dim` (`in_proj{i}`, bias-free Linear ->
    BN `in_bn{i}` -> relu), then `num_layers` BiFPN blocks `block1`..
    (agcn_tpu blocks.py:98-117). `in_dims` are the levels' widths."""

    def __init__(self, in_dims: Sequence[int], dim: int,
                 num_layers: int = 1):
        super().__init__()
        self.num_levels = len(in_dims)
        self.num_layers = num_layers
        for i, c in enumerate(in_dims):
            self.add_module(f"in_proj{i}", _dense(c, dim, False))
            self.add_module(f"in_bn{i}", BatchNorm(dim))
        for layer in range(1, num_layers + 1):
            self.add_module(f"block{layer}",
                            BiFPNBlock(dim, self.num_levels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_levels):
            _kaiming(getattr(self, f"in_proj{i}"), generator)
        for layer in range(1, self.num_layers + 1):
            getattr(self, f"block{layer}").reset_parameters(generator)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        feats = [torch.relu(getattr(self, f"in_bn{i}")(
            getattr(self, f"in_proj{i}")(f))) for i, f in enumerate(feats)]
        for layer in range(1, self.num_layers + 1):
            feats = getattr(self, f"block{layer}")(feats)
        return feats


class SeriesDecomposition(nn.Module):
    """Moving-average trend / seasonal split along time (agcn_tpu
    blocks.py:120-139): (x - trend, trend), trend = `moving_average`."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, x: torch.Tensor):
        trend = moving_average(x, self.kernel_size)
        return x - trend, trend
