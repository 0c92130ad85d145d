"""AAGCN — the attention-augmented adaptive graph convolution network in
PyTorch (port of agcn_tpu/models/aagcn.py).

Parity target: reference model/architecture/aagcn/aagcn.py
(SpatialAttention :59-76, TemporalAttention :79-96, ChannelAttention
:99-116, NonAdaptiveGCN :119-142, AdaptiveGCN :145-177, TCNUnit :184-207,
GCNUnit :210-271, TCNGCNUnit :274-322, BaseModel/Model :328-577).
Parameters carry the reference torch names (`l1.gcn1.agcn.PA`,
`l1.gcn1.agcn.alpha`, `l1.gcn1.attn_c.fc1c.weight`, ...). As in the
reference, the unit's `conv_d` projections are registered twice, as
`gcn1.conv_d.k` and `gcn1.agcn.conv_d.k`, over one shared module, so
`utils/weights.aagcn_state_dict_from_variables` loads with
`strict=True`.

Compute stays channels-last (B, T, V, C). With `dtype` set, activations
and the GCN/TCN weights are cast to it while parameters, BN statistics
and the attention softmax stay fp32; the STC attention modules promote to
their fp32 parameters as the JAX package's dtype-less flax layers do, so
a block's GCN unit ends in fp32 and its TCN casts back.

Eval mode runs `eval_formulation`, or 'agg' when it is unset, whatever
the training `formulation` (agcn_tpu aagcn.py:160-162): unlike AGCN, a
`pallas` AAGCN serves on the kernel only with `eval_formulation: pallas`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agcn_tpu_torch.ops import (BatchNorm, LayerNorm, PointwiseConv,
                                TemporalConv)
from agcn_tpu_torch.ops import gcn as gcn_ops
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import sync_batch_norms
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _promoted(x: torch.Tensor, *params: torch.Tensor):
    """x and the parameters in their common type (flax's promotion for a
    layer without a dtype)."""
    dtype = x.dtype
    for p in params:
        dtype = torch.promote_types(dtype, p.dtype)
    return (x.to(dtype),) + tuple(p.to(dtype) for p in params)


class SpatialAttention(nn.Module):
    """SE attention over joints (reference aagcn.py:59-76)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pad = (kernel_size - 1) // 2
        self.conv_sa = nn.utils.skip_init(nn.Conv1d, channels, 1,
                                          kernel_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.xavier_normal(self.conv_sa.weight, generator)
        init.constant(0.0)(self.conv_sa.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se, w, b = _promoted(x.mean(dim=1), self.conv_sa.weight,
                             self.conv_sa.bias)  # (B, V, C)
        se = F.conv1d(se.transpose(1, 2), w, b, padding=self.pad)
        se = torch.sigmoid(se).transpose(1, 2)  # (B, V, 1)
        return x * se[:, None] + x


class TemporalAttention(nn.Module):
    """SE attention over frames (reference aagcn.py:79-96); zero-init conv."""

    def __init__(self, channels: int, kernel_size: int = 9):
        super().__init__()
        self.pad = (kernel_size - 1) // 2
        self.conv_ta = nn.utils.skip_init(nn.Conv1d, channels, 1,
                                          kernel_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.constant(0.0)(self.conv_ta.weight, generator)
        init.constant(0.0)(self.conv_ta.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se, w, b = _promoted(x.mean(dim=2), self.conv_ta.weight,
                             self.conv_ta.bias)  # (B, T, C)
        se = F.conv1d(se.transpose(1, 2), w, b, padding=self.pad)
        se = torch.sigmoid(se).transpose(1, 2)  # (B, T, 1)
        return x * se[:, :, None] + x


class ChannelAttention(nn.Module):
    """SE attention over channels (reference aagcn.py:99-116)."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.fc1c = nn.utils.skip_init(nn.Linear, channels,
                                       channels // reduction)
        self.fc2c = nn.utils.skip_init(nn.Linear, channels // reduction,
                                       channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.kaiming_normal_fan_in(self.fc1c.weight, generator)
        for p in (self.fc1c.bias, self.fc2c.weight, self.fc2c.bias):
            init.constant(0.0)(p, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se, w1, b1, w2, b2 = _promoted(
            x.mean(dim=(1, 2)), self.fc1c.weight, self.fc1c.bias,
            self.fc2c.weight, self.fc2c.bias)  # (B, C)
        se = torch.relu(F.linear(se, w1, b1))
        se = torch.sigmoid(F.linear(se, w2, b2))
        return x * se[:, None, None] + x


class AdaptiveGCN(nn.Module):
    """Learned adjacency + alpha-gated embedding attention + projections:
    z = sum_k W_k ( x @ (PA_k + alpha * C_k(x)) ) (aagcn.py:145-177).

    `conv_d` is the unit's module list, registered here again as the
    reference does. With an `edge_mesh` whose 'edge' axis has more than
    one rank the aggregation is edge-partitioned over it
    (parallel/edge_partition.model_edge_gcn; aagcn.py:147-155), in train
    and eval mode. Inside `models.exposure.recording_graphs` it records
    its a1 (the JAX unit's sown 'g')."""

    graph_record: Optional[List[torch.Tensor]] = None

    def __init__(self, in_channels: int, inter_channels: int,
                 adj: np.ndarray, conv_d: nn.ModuleList,
                 dtype: Optional[torch.dtype] = None,
                 formulation: str = "agg_packed",
                 attn_form: str = "transposed",
                 eval_formulation: Optional[str] = None,
                 edge_mesh: Any = None):
        super().__init__()
        k = adj.shape[0]
        self.inter_c = inter_channels
        self.dtype = dtype
        self.edge_mesh = edge_mesh
        self.formulation = formulation
        self.attn_form = attn_form
        self.eval_formulation = eval_formulation
        self.adj = np.asarray(adj, np.float32)
        self.PA = nn.Parameter(torch.empty(adj.shape))
        self.alpha = nn.Parameter(torch.empty(1))
        self.conv_a = nn.ModuleList(
            PointwiseConv(in_channels, inter_channels) for _ in range(k))
        self.conv_b = nn.ModuleList(
            PointwiseConv(in_channels, inter_channels) for _ in range(k))
        self.conv_d = conv_d

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.PA.copy_(torch.from_numpy(self.adj))
            self.alpha.zero_()
        for m in (*self.conv_a, *self.conv_b):
            init.kaiming_normal_fan_out(m.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_c = x.shape[-1]
        k = self.PA.shape[0]
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
        a1 = self.PA[None].to(att.dtype) + att * self.alpha.to(att.dtype)
        if self.graph_record is not None:
            self.graph_record.append(a1)

        w_stack = _cast(torch.stack([m.weight.view(-1, in_c).t()
                                     for m in self.conv_d]), self.dtype)
        out_b = _cast(sum(m.bias for m in self.conv_d), self.dtype)
        if self.edge_mesh is not None \
                and self.edge_mesh.shape.get("edge", 1) > 1:
            from agcn_tpu_torch.parallel.edge_partition import model_edge_gcn

            return model_edge_gcn(compute, a1, w_stack,
                                  self.edge_mesh) + out_b
        # eval runs eval_formulation or 'agg', even for the pallas forms
        form = (self.formulation if self.training
                else self.eval_formulation or "agg")
        return gcn_ops.apply_gcn(compute, a1, w_stack, form) + out_b


class NonAdaptiveGCN(nn.Module):
    """Fixed-adjacency aggregation + projections (aagcn.py:119-142): the
    K-subset aggregate+project+sum as one (V*Cin, V*Cout) operator. The
    unit's `conv_d` is used, not registered (the reference names it only
    under the unit)."""

    def __init__(self, adj: np.ndarray, conv_d: Sequence[PointwiseConv]):
        super().__init__()
        self.register_buffer("A", torch.as_tensor(adj, dtype=torch.float32),
                             persistent=False)
        self.conv_d = tuple(conv_d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_c = x.shape[-1]
        kernels = torch.stack([m.weight.view(-1, in_c).t()
                               for m in self.conv_d])
        operator = gcn_ops.fused_static_operator(self.A.to(x.dtype),
                                                 kernels.to(x.dtype))
        y = gcn_ops.apply_fused_static(x, operator, self.A.shape[-1])
        # fp32 biases: a bf16 y comes out in fp32, as in the JAX package
        return y + sum(m.bias for m in self.conv_d)


class GCNUnit(nn.Module):
    """Graph conv + BN + residual + ReLU + optional STC attention
    (reference aagcn.py:210-271)."""

    def __init__(self, in_channels: int, out_channels: int, adj: np.ndarray,
                 coff_embedding: int = 4, adaptive: bool = True,
                 attention: bool = True, gbn_split: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 formulation: str = "agg_packed",
                 attn_form: str = "transposed", fold_bn: bool = False,
                 eval_formulation: Optional[str] = None,
                 edge_mesh: Any = None):
        super().__init__()
        k, v = adj.shape[0], adj.shape[-1]
        self.conv_d = nn.ModuleList(
            PointwiseConv(in_channels, out_channels) for _ in range(k))
        if adaptive:
            self.agcn = AdaptiveGCN(in_channels,
                                    out_channels // coff_embedding, adj,
                                    self.conv_d, dtype=dtype,
                                    formulation=formulation,
                                    attn_form=attn_form,
                                    eval_formulation=eval_formulation,
                                    edge_mesh=edge_mesh)
        else:
            self.agcn = NonAdaptiveGCN(adj, self.conv_d)
        self.attention = attention
        if attention:
            self.attn_s = SpatialAttention(out_channels,
                                           v if v % 2 else v - 1)
            self.attn_t = TemporalAttention(out_channels)
            self.attn_c = ChannelAttention(out_channels)
        self.bn = BatchNorm(out_channels, scale_init_value=1e-6,
                            splits=gbn_split, identity_at_eval=fold_bn)
        self.down = None
        if in_channels != out_channels:
            self.down = nn.Sequential(
                PointwiseConv(in_channels, out_channels, dtype=dtype),
                BatchNorm(out_channels, splits=gbn_split,
                          identity_at_eval=fold_bn))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.conv_d:
            init.conv_branch_init(len(self.conv_d))(m.weight, generator)
        if isinstance(self.agcn, AdaptiveGCN):
            self.agcn.reset_parameters(generator)
        if self.down is not None:
            init.kaiming_normal_fan_out(self.down[0].weight, generator)
        if self.attention:
            for m in (self.attn_s, self.attn_t, self.attn_c):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.agcn(x))
        down = x if self.down is None else self.down(x)
        y = torch.relu(y + down)
        if self.attention:
            y = self.attn_c(self.attn_t(self.attn_s(y)))
        return y


class TCNUnit(nn.Module):
    """Temporal conv + BN (reference aagcn.py:184-207)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, pad: bool = True,
                 gbn_split: int = 1, dtype: Optional[torch.dtype] = None,
                 fold_bn: bool = False):
        super().__init__()
        self.conv = TemporalConv(in_channels, out_channels, kernel_size,
                                 stride, dtype=dtype, pad=pad)
        self.bn = BatchNorm(out_channels, splits=gbn_split,
                            identity_at_eval=fold_bn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.kaiming_normal_fan_out(self.conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class TCNGCNUnit(nn.Module):
    """GCN -> TCN -> +residual -> ReLU (reference aagcn.py:274-322)."""

    def __init__(self, in_channels: int, out_channels: int, adj: np.ndarray,
                 stride: int = 1, residual: bool = True, kernel_size: int = 9,
                 pad: bool = True, gbn_split: int = 1,
                 dtype: Optional[torch.dtype] = None, fold_bn: bool = False,
                 **gcn_kwargs: Any):
        super().__init__()
        self.gcn1 = GCNUnit(in_channels, out_channels, adj,
                            gbn_split=gbn_split, dtype=dtype,
                            fold_bn=fold_bn, **gcn_kwargs)
        self.tcn1 = TCNUnit(out_channels, out_channels, kernel_size, stride,
                            pad, gbn_split=gbn_split, dtype=dtype,
                            fold_bn=fold_bn)
        self.has_residual = residual
        self.residual = None
        if residual and (in_channels != out_channels or stride != 1):
            self.residual = TCNUnit(in_channels, out_channels, kernel_size=1,
                                    stride=stride, gbn_split=gbn_split,
                                    dtype=dtype, fold_bn=fold_bn)

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


# model_layers -> {layer name: (out_channels, stride, residual, pad)}
# (reference aagcn.py:407-474); a stride or pad of None takes the model's
# default
Plan = Dict[str, Tuple[int, Optional[int], bool, Optional[bool]]]
_LAYER_PLANS: Dict[int, Plan] = {
    0: {},
    3: {"l1": (64, 1, False, None), "l5": (128, 2, True, None),
        "l8": (256, 2, True, None)},
    6: {"l1": (64, 1, False, None), "l4": (64, 1, True, None),
        "l5": (128, 2, True, None), "l7": (128, 1, True, None),
        "l8": (256, 2, True, None), "l10": (256, 1, True, None)},
    7: {"l1": (64, 1, False, None), "l3": (64, 1, True, None),
        "l4": (64, 1, True, None), "l5": (128, 2, True, None),
        "l7": (128, 1, True, None), "l8": (256, 2, True, None),
        "l10": (256, 1, True, None)},
    10: {"l1": (64, 1, False, None), "l2": (64, 1, True, None),
         "l3": (64, 1, True, None), "l4": (64, 1, True, None),
         "l5": (128, 2, True, None), "l6": (128, 1, True, None),
         "l7": (128, 1, True, None), "l8": (256, 2, True, None),
         "l9": (256, 1, True, None), "l10": (256, 1, True, None)},
}


def layer_plan(model_layers: int, output_channel: int = 64) -> Plan:
    """The blocks of a `model_layers` setting (agcn_tpu aagcn.py:351-374)."""
    if model_layers in _LAYER_PLANS:
        return dict(_LAYER_PLANS[model_layers])
    c = output_channel
    if model_layers in (101, 102, 103):
        n = model_layers - 100
        plan = {"l1": (c, None, False, None)}
        for i in range(2, n + 1):
            plan[f"l{i}"] = (c, None, True, None)
        return plan
    if model_layers == 1002:
        # the reference's `padding=` keyword, which its units do not
        # take, as its documented intent: pad=True (aagcn.py:464-467)
        return {"l1": (c, 1, False, True), "l2": (c, None, True, None)}
    if model_layers == 1003:
        return {"l1": (c, 1, False, True), "l2": (c, 1, True, True),
                "l3": (c, None, True, None)}
    raise ValueError(f"Model with {model_layers} layers is not supported.")


class AAGCN(nn.Module):
    """The full AAGCN classifier (reference aagcn.py:328-577).

    Input: (N, C, T, V, M) skeleton sequences. Output: (N, num_class) fp32
    logits (the JAX model's first output; its second, the reference's
    attention slot, is always None).

    Built on the CPU, initialized from `generator` (seed 0 when None) and
    moved to `device`, `cuda` unless the caller names another. Dropout
    (`drop_out`, train mode only) draws its masks from a generator on that
    device, seeded from `generator`. `sync_axis` puts every BatchNorm on
    that axis of the bound mesh (SyncBN); `edge_mesh` partitions each
    adaptive unit's aggregation over its 'edge' axis.
    """

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3,
                 adj: Optional[np.ndarray] = None, drop_out: float = 0.0,
                 adaptive: bool = True, attention: bool = True,
                 gbn_split: int = 1, fc_cv: bool = False,
                 data_norm: str = "bn", model_layers: int = 10,
                 kernel_size: int = 9, stride: int = 1, pad: bool = True,
                 backbone_dim: Optional[int] = None,
                 formulation: str = "agg_packed",
                 attn_form: str = "transposed",
                 sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, edge_mesh: Any = None,
                 fold_bn: bool = False,
                 eval_formulation: Optional[str] = None,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if adj is None:
            raise ValueError("adj: the (K, V, V) adjacency stack is required")
        if data_norm == "bn":
            self.data_bn = BatchNorm(num_person * num_point * in_channels,
                                     splits=gbn_split)
        elif data_norm == "ln":
            self.data_bn = LayerNorm(num_point * in_channels)
        else:
            raise ValueError("Unknown data_norm")
        self.data_norm = data_norm
        self.dtype = dtype
        self.drop_out = drop_out
        self.fc_cv = fc_cv
        self.num_class = num_class
        common = dict(adaptive=adaptive, attention=attention,
                      kernel_size=kernel_size, gbn_split=gbn_split,
                      formulation=formulation, attn_form=attn_form,
                      dtype=dtype, fold_bn=fold_bn,
                      eval_formulation=eval_formulation, edge_mesh=edge_mesh)
        plan = layer_plan(model_layers, backbone_dim or 64)
        self.block_names = []
        c = in_channels
        for name in [f"l{i}" for i in range(1, 11)]:
            if name not in plan:
                continue
            ch, st, residual, pd = plan[name]
            self.add_module(name, TCNGCNUnit(
                c, ch, adj, stride=stride if st is None else st,
                residual=residual, pad=pad if pd is None else pd, **common))
            self.block_names.append(name)
            c = ch
        fc_in = c * num_point if fc_cv else c
        # skip_init: nn.Linear's own init would draw from the global RNG
        self.fc = nn.utils.skip_init(nn.Linear, fc_in, num_class)
        if sync_axis is not None:  # every BN of the model (:233-419)
            sync_batch_norms(self, sync_axis)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.reset_parameters(generator)
        self.to(device)
        self.dropout_generator = None
        if drop_out:
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.block_names:
            getattr(self, name).reset_parameters(generator)
        init.fc_init(self.num_class)(self.fc.weight, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        if self.data_norm == "bn":
            # (N, C, T, V, M) -> (N, T, M*V*C): the reference's data_bn
            # channel order (m, v, c), aagcn.py:483-487
            x = x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * c)
            x = self.data_bn(x)
            x = x.reshape(n, t, m, v, c).permute(0, 2, 1, 3, 4).reshape(
                n * m, t, v, c)
        else:
            # LayerNorm over (V, C) per frame (aagcn.py:489-492)
            x = x.permute(0, 4, 2, 3, 1).reshape(n * m, t, v * c)
            x = self.data_bn(x).reshape(n * m, t, v, c)
        x = _cast(x, self.dtype)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.float()
        if self.fc_cv:
            # per-joint pooling: mean over T and persons, (C, V) flattened
            # (aagcn.py:513-516)
            x = x.mean(dim=1).reshape(n, m, v, -1).mean(dim=1)
            x = x.permute(0, 2, 1).reshape(n, -1)
        else:
            x = x.mean(dim=(1, 2)).reshape(n, m, -1).mean(dim=1)
        if self.drop_out and self.training:
            keep = torch.rand(x.shape, generator=self.dropout_generator,
                              device=x.device) >= self.drop_out
            x = torch.where(keep, x / (1.0 - self.drop_out), 0.0)
        return self.fc(x)
