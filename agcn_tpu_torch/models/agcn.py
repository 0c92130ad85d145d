"""AGCN — the original 2s-AGCN model (CVPR'19) in PyTorch
(port of agcn_tpu/models/agcn.py).

Parity target: reference model/architecture/aagcn/agcn.py (unit_tcn
:36-50, unit_gcn :53-109, TCN_GCN_unit :112-129, Model :132-183).
Parameters carry the reference torch names and shapes (`l1.gcn1.PA`,
`l1.gcn1.conv_a.0.weight`, `l1.tcn1.conv.weight`, `data_bn.running_mean`,
...), so `utils/weights.agcn_state_dict_from_variables` moves the JAX
package's weights in with a strict load. The compute stays channels-last
(B, T, V, C) as in the JAX package; with `dtype` set, activations and
weights are cast to it at use while parameters, BN statistics and the
attention softmax stay fp32.

Train mode (`model.train()`, torch's default) normalizes with batch
statistics and runs the configured GCN `formulation`; eval mode keeps the
pallas formulations and takes the eval default 'agg' for the einsum
forms, as the JAX package does (agcn.py:135-138). `remat` recomputes each
block's forward in the backward (`torch.utils.checkpoint`), without
updating the BN running statistics a second time.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from agcn_tpu_torch.ops import BatchNorm, PointwiseConv, TemporalConv
from agcn_tpu_torch.ops import gcn as gcn_ops
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import recomputing
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


class UnitGCN(nn.Module):
    """Adaptive graph convolution over K spatial subsets.

    y = BN( sum_k W_k ( x @ (A_k + PA_k + C_k(x)) ) ) + down(x), then ReLU.
    Parity: reference agcn.py:53-109.
    """

    def __init__(self, in_channels: int, out_channels: int, adj: np.ndarray,
                 coff_embedding: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 use_pallas: bool = False, formulation: str = "agg_packed",
                 attn_form: str = "transposed", fold_bn: bool = False,
                 eval_formulation: Optional[str] = None):
        super().__init__()
        k = adj.shape[0]
        self.inter_c = out_channels // coff_embedding
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.formulation = formulation
        self.attn_form = attn_form
        self.eval_formulation = eval_formulation
        # the static partition stack is no parameter of the reference
        self.register_buffer("A", torch.as_tensor(adj, dtype=torch.float32),
                             persistent=False)
        self.PA = nn.Parameter(torch.empty(adj.shape))
        self.conv_a = nn.ModuleList(
            PointwiseConv(in_channels, self.inter_c) for _ in range(k))
        self.conv_b = nn.ModuleList(
            PointwiseConv(in_channels, self.inter_c) for _ in range(k))
        self.conv_d = nn.ModuleList(
            PointwiseConv(in_channels, out_channels) for _ in range(k))
        self.bn = BatchNorm(out_channels, scale_init_value=1e-6,
                            identity_at_eval=fold_bn)
        self.down = None
        if in_channels != out_channels:
            self.down = nn.Sequential(
                PointwiseConv(in_channels, out_channels, dtype=self.dtype),
                BatchNorm(out_channels, identity_at_eval=fold_bn))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.constant(1e-6)(self.PA, generator)
        for m in (*self.conv_a, *self.conv_b):
            init.kaiming_normal_fan_out(m.weight, generator)
        for m in self.conv_d:
            init.conv_branch_init(len(self.conv_d))(m.weight, generator)
        if self.down is not None:
            init.kaiming_normal_fan_out(self.down[0].weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_c = x.shape[-1]
        k = self.A.shape[0]
        compute = _cast(x, self.dtype)
        # the K subsets' theta/phi projections as one wide GEMM:
        # channels [theta_0..theta_{K-1}, phi_0..phi_{K-1}]
        emb_w = torch.cat([m.weight.view(-1, in_c)
                           for m in (*self.conv_a, *self.conv_b)])
        emb_b = torch.cat([m.bias for m in (*self.conv_a, *self.conv_b)])
        emb = F.linear(compute, _cast(emb_w, self.dtype),
                       _cast(emb_b, self.dtype))  # (B, T, V, 2*K*Ce)
        logits = gcn_ops.attention_logits(emb, k, self.inter_c,
                                          self.attn_form)
        # softmax over the source joint in fp32, back to the compute dtype
        att = torch.softmax(logits.float(), dim=-2).to(compute.dtype)
        a1 = att + (self.A + self.PA)[None].to(att.dtype)  # (B, K, V, V)

        w_stack = _cast(torch.stack([m.weight.view(-1, in_c).t()
                                     for m in self.conv_d]), self.dtype)
        out_b = _cast(sum(m.bias for m in self.conv_d), self.dtype)
        if self.use_pallas:
            from agcn_tpu_torch.ops.kernels.gcn_kernel import fused_gcn

            y = fused_gcn(compute, a1, w_stack) + out_b
        else:
            # training runs the configured formulation; at eval the
            # pallas formulations keep their fused forward kernel and the
            # einsum forms take the eval default 'agg'
            # (agcn_tpu agcn.py:135-138)
            form = (self.formulation
                    if self.training or self.formulation.startswith("pallas")
                    else self.eval_formulation or "agg")
            y = gcn_ops.apply_gcn(compute, a1, w_stack, form) + out_b
        y = self.bn(y)
        down = x if self.down is None else self.down(x)
        return torch.relu(y + down)


class UnitTCN(nn.Module):
    """kx1 temporal conv + BN (no activation). Parity: agcn.py:36-50."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1,
                 dtype: Optional[torch.dtype] = None, fold_bn: bool = False):
        super().__init__()
        self.conv = TemporalConv(in_channels, out_channels, kernel_size,
                                 stride, dtype=dtype)
        self.bn = BatchNorm(out_channels, identity_at_eval=fold_bn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.kaiming_normal_fan_out(self.conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class STGCNBlock(nn.Module):
    """GCN -> TCN with residual and ReLU. Parity: agcn.py:112-129."""

    def __init__(self, in_channels: int, out_channels: int, adj: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 dtype: Optional[torch.dtype] = None, fold_bn: bool = False,
                 **gcn_kwargs: Any):
        super().__init__()
        self.gcn1 = UnitGCN(in_channels, out_channels, adj, dtype=dtype,
                            fold_bn=fold_bn, **gcn_kwargs)
        self.tcn1 = UnitTCN(out_channels, out_channels, stride=stride,
                            dtype=dtype, fold_bn=fold_bn)
        self.has_residual = residual
        self.residual = None
        if residual and (in_channels != out_channels or stride != 1):
            self.residual = UnitTCN(in_channels, out_channels, kernel_size=1,
                                    stride=stride, dtype=dtype,
                                    fold_bn=fold_bn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gcn1.reset_parameters(generator)
        self.tcn1.reset_parameters(generator)
        if self.residual is not None:
            self.residual.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.tcn1(self.gcn1(x))
        if not self.has_residual:
            return torch.relu(y)
        res = x if self.residual is None else self.residual(x)
        return torch.relu(y + res)


# 10-block channel/stride plan of the original model (agcn.py:145-154).
BACKBONE_PLAN: Tuple[Tuple[int, int, bool], ...] = (
    (64, 1, False), (64, 1, True), (64, 1, True), (64, 1, True),
    (128, 2, True), (128, 1, True), (128, 1, True),
    (256, 2, True), (256, 1, True), (256, 1, True),
)


class AGCN(nn.Module):
    """The full AGCN classifier. Parity: reference agcn.py:132-183.

    Input: (N, C, T, V, M) skeleton sequences (the on-disk data contract).
    Output: (N, num_class) fp32 logits.

    The model is built on the CPU, initialized from `generator` (a
    `torch.Generator`; seed 0 when None) and moved to `device`, which is
    `cuda` unless the caller names another.
    """

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3,
                 adj: Optional[np.ndarray] = None,
                 dtype: Optional[torch.dtype] = None,
                 use_pallas: bool = False, formulation: str = "agg_packed",
                 attn_form: str = "transposed", edge_mesh: Any = None,
                 remat: bool = False, scan_blocks: bool = False,
                 fold_bn: bool = False,
                 eval_formulation: Optional[str] = None,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if scan_blocks:
            raise NotImplementedError(
                "scan_blocks stacks the block parameters on a leading axis "
                "(a layout the reference state dict does not have); the "
                "port runs the unrolled model only")
        if edge_mesh is not None:
            raise NotImplementedError(
                "edge_mesh (in-model edge partitioning) is not ported yet "
                "(ROADMAP, Queue 1: Parallel)")
        if adj is None:
            raise ValueError("adj: the (K, V, V) adjacency stack is required")
        self.remat = remat
        self.dtype = dtype
        self.data_bn = BatchNorm(num_person * num_point * in_channels)
        common = dict(dtype=self.dtype, use_pallas=use_pallas,
                      formulation=formulation, attn_form=attn_form,
                      fold_bn=fold_bn, eval_formulation=eval_formulation)
        self.block_names = []
        in_c = in_channels
        for i, (ch, stride, residual) in enumerate(BACKBONE_PLAN):
            name = f"l{i + 1}"
            self.add_module(name, STGCNBlock(in_c, ch, adj, stride=stride,
                                             residual=residual, **common))
            self.block_names.append(name)
            in_c = ch
        # skip_init: nn.Linear's own init would draw from the global RNG
        self.fc = nn.utils.skip_init(nn.Linear, in_c, num_class)
        self.num_class = num_class
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.block_names:
            getattr(self, name).reset_parameters(generator)
        init.fc_init(self.num_class)(self.fc.weight, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return block(x)
        # the block's activations are recomputed in the backward (JAX
        # nn.remat, agcn.py:341-342); the recompute leaves BN stats alone
        return checkpoint(block, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              recomputing(block)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        # (N, C, T, V, M) -> (N, T, M*V*C): channel order (m, v, c)
        # matches the reference's data_bn layout (agcn.py:163-165)
        x = x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * c)
        x = self.data_bn(x)
        # fold persons into the batch: (N*M, T, V, C)
        x = x.reshape(n, t, m, v, c).permute(0, 2, 1, 3, 4).reshape(
            n * m, t, v, c)
        x = _cast(x, self.dtype)
        for name in self.block_names:
            x = self._block(name, x)
        # global pooling: mean over (T, V), then persons (agcn.py:178-182)
        x = x.float().mean(dim=(1, 2)).reshape(n, m, -1).mean(dim=1)
        return self.fc(x)
