"""SGN — Semantics-Guided Network (port of agcn_tpu/models/sgn.py, every
option of the JAX model).

Parity target: reference model/architecture/sgn/sgn_v14.py (sgn_v12.py for
the InfoGCN head) and blocks/{feature_extractor,semantic,spatial,temporal}.py.
The input is the SGN loader's (B, seg, V*C) segments (persons flattened
into time by the collate). In order:

- position and velocity embeddings (`SGNEmbedding`, every mode of
  `EMB_MODES`), each behind a DataNorm over the (c, v)-ordered features;
  velocity is x[t] - x[t-1] with a leading zero frame; with both modes
  above 1000 the body-part segment embeddings instead (`SegmentEmbedding`:
  the 8 part groups of `SEGMENTS` over windows of `SEGMENT_PERIOD`
  frames, both streams of x, as in the reference), after which the graph
  has 8 nodes and seg // 4 frames;
- the one-hot joint embedding, fused by concatenation or sum
  (`semantic_jdiff`: fused into the position stream, and a second one,
  `jdiff_embedding`, into the velocity stream), the projection
  `x_emb_projection` (`xem_projection`), and the one-hot frame
  embedding, added after the GCN stack (location 0) or before it at the
  stack's input width (location 1);
- the GCN stack (`GCNSpatialBlock`): G from the G module, shared by every
  unit when `sgcn_g_proj_dim` is an int (one per unit for a list, each
  blended with the previous unit's G under `sgcn_g_weighted`): gt_mode 0
  (`GCNSpatialG`: act(g1 g2^T)), 1 (`GCNSpatialGT`: per-frame g1 g2^T
  mixed by a frame-to-frame softmax of the joint-max descriptors g3, g4,
  then a softmax or sigmoid), 2-4 (`GCNSpatialGTScalar`: G = act(g1 g2^T)
  and a per-frame scalar of the flattened joints, which scales G (2, 3)
  or gates the unit's input (4)) or 5-6 (`GCNSpatialGTMap`: G and the
  frames' flattened maps plus a one-hot frame embedding, through GT5's
  head `g3`), its projections convs over T of `sgcn_g_kernel`; units
  (`GCNSpatialUnit`) by `sgcn_attn_mode`: 0 w1(G x) + res_alpha w2(x), 1
  without G, 2 a squeeze-excite gate, 3 w2 alone, 10 mode 0 with w2 on an
  injected level; `sgcn_v_kernel`'s conv w0 before the aggregation,
  w2's `sgcn_kernel` / `sgcn_padding`; then BN (before the unit under
  `sgcn_prenorm`) -> relu -> dropout2d, the residual `sgcn_residual`
  and the FFN `sgcn_ffn` (`GCNSpatialFFN`, `ffn_variant`);
- the GCN-FPN, the levels that feed the temporal module: the last unit's
  output (`gcn_fpn: -1`), every unit's (0), the projections
  `fpn_proj{i}[_k{k}]` of every unit's output (1-7, 9: summed from level
  i upward, kept apart, or concatenated after the spatial pool), the
  BiFPN `bifpn` over every unit's output (8, `ops/blocks.BiFPN` of
  `bifpn_dim`, which the frame embedding then takes), or the last output
  of a second stack `sgcn2` (10: the `sgcn2_*` options, G fixed to the
  first stack's last, the injected levels the first stack's input and
  outputs), each plus the frame embedding where the widths agree;
- under `semantic_joint_smp` a one-hot joint embedding of `sgcn_dims[-1]`
  concatenated on the channels of every level;
- the spatial pool (`spatial_maxpool`: 0 none, 1 the max, 3-5 VALID convs
  over the joints `smp{i}_k_*` and 1x1 convs `smp{i}_1x1_*`), GT6's
  maps as a level of their own, the temporal branches of `multi_t` on
  those levels (`TemporalBranch`: an optional `ASPP` (`aspp_rates`), then
  t_mode 0 (the feature itself), 1 (conv k -> BN -> relu -> dropout2d,
  then 1x1 -> BN -> relu; BN first under `sgcn_prenorm`), 2 (the same
  with residuals), 3 (a transformer encoder over the frames,
  `t_mha_kwargs`), 4 (a series decomposition and three t_mode-2 MLPs) or
  5 (t_mode-2 MLPs over moving averages of `pool_kernel_sizes`);
  `t_maxpool_kwargs` max-pools time before a t_mode 1 / 2 MLP; with
  `multi_t_shared: 2` one branch a (slot, kernel) pair, named after the
  first level that declares it, applied to every level), GT5's head
  beside their outputs, the mean of all of them (each apart under
  `gcn_fpn_output_merge: 2`), the temporal pool (`temporal_maxpool`: 0
  none, 1 the max, 2 the max plus `tmp_ind_projection` of the argmax
  frame, 3-5 the VALID conv over the frames `tmp_k_*` and the 1x1
  `tmp_1x1_*`), the class embedding (`semantic_class`), the InfoGCN head
  (`infogcn_*`: z = mu + eps * std in training, mu in eval, and the fixed
  prior `z_prior`), dropout and `fc` (merge 2: a head `fc{i}` an output,
  the logits averaged), whose input is what the pools leave.

`forward(x, return_aux=True)` also returns the JAX model's aux outputs
(agcn_tpu sgn.py:1226-1261): `g` (the list of G: the first of each of
JAX's (G, aux) pairs), `branch_outputs` (each temporal output, GT5's
head's too, in the reference's (N, C, T') layout, for the
feature-similarity loss), `z` (the classifier's input before its
dropout: the latent under the InfoGCN head, the first output's under
merge 2) and, with the head, `z_prior`.

Layout is channels-last (B, T, V, C); every 1xk kernel keeps the
reference's (out, in, 1, k) layout over its (N, C, V, T) grid, and the
module and parameter names are the reference's (the names
`utils/weights.sgn_state_dict_from_variables` writes), so a reference
state dict loads strictly; the blocks the JAX export has no names for
(`ops/blocks.py`, a branch's `res2`, `mha`, `cnn_raw` ..., the pools'
convs) carry the JAX modules' names, and so do, near them, the input-side
embeddings (`semantic_embedding.jdiff_embedding`, `x_emb_projection`,
`semantic_embedding.joint_smp_embedding`). The one-hot tables are the
reference's buffers (`semantic_embedding.spa_onehot.onehot` (1, V, V,
seg), `tem_onehot.onehot` (1, seg, V, seg), `cls_onehot.onehot` (1, 1, 1,
1) and GT5 / GT6's `tem_onehot.onehot` (1, seg, 1, seg)), so the model is
built for the loader's `seg` (`num_segment`). The max-pools call
`torch.amax`, the ReLUs `torch.relu` and the head's eps `latent_noise`
(the calls that tools/grad_parity.py's probes replay).

SGN runs in fp32, as in the JAX package.
"""


from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agcn_tpu_torch.ops import BatchNorm
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.attention import Dropout, TransformerEncoder
from agcn_tpu_torch.ops.blocks import (ASPP, BiFPN, SeriesDecomposition,
                                       moving_average)
from agcn_tpu_torch.ops.gcn import frame_aggregate, frame_attention
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# channel constants c1..c4 (reference model/resource/common_ntu.py:1-6)
C1, C2, C3, C4 = 64, 128, 256, 512

EMB_MODES = {
    # mode: (num_layers, kernel_sizes, residual)
    1: (2, (1, 1), 0),
    2: (2, (1, 1), 1),
    3: (3, (1, 1, 1), 0),
    4: (4, (1, 1, 1, 1), 0),
    11: (2, (1, 3), 0),
    12: (2, (3, 3), 0),
}


class Conv1xN(nn.Module):
    """A 1xk conv along T (reference Conv1xN, block.py:154-189): `conv`
    holds the reference's (out, in, 1, k) kernel over its (N, C, V, T)
    grid; here it runs on (B, T, V, C), a matmul when k = 1."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 1, padding: int = 0,
                 use_bias: bool = False):
        super().__init__()
        self.conv = nn.utils.skip_init(
            nn.Conv2d, in_features, features, (1, kernel_size),
            padding=(0, padding), bias=use_bias)

    def reset_parameters(self, generator: torch.Generator,
                         kernel=init.kaiming_normal_fan_out) -> None:
        w = self.conv.weight
        kernel(w, generator)
        if self.conv.bias is not None:
            init.torch_default(w.shape[1] * w.shape[3])(self.conv.bias,
                                                        generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.conv.weight, self.conv.bias
        if w.shape[-1] == 1:
            return F.linear(x, w.view(w.shape[0], w.shape[1]), b)
        y = F.conv2d(x.permute(0, 3, 2, 1), w, b,
                     padding=self.conv.padding)  # (B, C, V, T)
        return y.permute(0, 3, 2, 1)


class LinearLayer(nn.Module):
    """The reference LinearLayer (block.py:120-125): `linear`, an
    nn.Linear over the channels, numerically a 1x1 `Conv1xN`."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False):
        super().__init__()
        self.linear = nn.utils.skip_init(nn.Linear, in_features, features,
                                         bias=use_bias)

    def reset_parameters(self, generator: torch.Generator,
                         kernel=init.kaiming_normal_fan_out) -> None:
        kernel(self.linear.weight, generator)
        if self.linear.bias is not None:
            init.torch_default(self.linear.in_features)(self.linear.bias,
                                                        generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class _Block(nn.Module):
    """The reference Conv's `block`: `conv` [+ `norm`] (the LinearLayer's:
    `linear` [+ `norm`])."""

    def __init__(self, layer: nn.Module, norm: Optional[BatchNorm]):
        super().__init__()
        self.add_module("linear" if isinstance(layer, LinearLayer)
                        else "conv", layer)
        if norm is not None:
            self.norm = norm


class ConvNormAct(nn.Module):
    """conv -> [norm] -> [relu] -> [dropout2d] (reference Conv,
    block.py:192-227; agcn_tpu sgn.py:102-128); `prenorm` moves the norm
    before the conv, at the input's width; `linear` makes the conv a
    `LinearLayer` (kernel 1). Dropout2d drops whole channels of a sample
    (flax broadcast_dims (1, 2))."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 1, padding: int = 0,
                 use_bias: bool = False, use_norm: bool = False,
                 use_act: bool = True, dropout: float = 0.0,
                 prenorm: bool = False, linear: bool = False):
        super().__init__()
        layer = (LinearLayer(in_features, features, use_bias) if linear
                 else Conv1xN(in_features, features, kernel_size, padding,
                              use_bias))
        self.block = _Block(layer, BatchNorm(
            in_features if prenorm else features) if use_norm else None)
        self.use_norm = use_norm
        self.prenorm = prenorm
        self.use_act = use_act
        self.drop = Dropout(dropout, (1, 2)) if dropout > 0.0 else None

    @property
    def layer(self) -> nn.Module:
        return (self.block.linear if hasattr(self.block, "linear")
                else self.block.conv)

    def reset_parameters(self, generator: torch.Generator,
                         kernel=init.kaiming_normal_fan_out) -> None:
        self.layer.reset_parameters(generator, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_norm and self.prenorm:
            x = self.block.norm(x)
        x = self.layer(x)
        if self.use_norm and not self.prenorm:
            x = self.block.norm(x)
        if self.use_act:
            x = torch.relu(x)
        if self.drop is not None:
            x = self.drop(x)
        return x


class DataNorm(nn.Module):
    """BatchNorm1d over the C*V features of each frame in the reference's
    (c, v) order, statistics over (B, T) (blocks/semantic.py:21-31)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, v, c = x.shape
        y = self.bn(x.permute(0, 1, 3, 2).reshape(b, t, c * v))
        return y.reshape(b, t, c, v).permute(0, 1, 3, 2)


class SGNEmbedding(nn.Module):
    """Input / semantic embedding MLP (reference blocks/semantic.py:34-125;
    agcn_tpu sgn.py:131-162): [DataNorm] then `EMB_MODES[mode]` layers of
    conv -> relu; mode 2 adds each layer's input back, through `res{i}`
    where the widths differ."""

    def __init__(self, in_channels: int, out_channels: int, mode: int = 1,
                 use_bias: bool = True, in_norm_features: int = 0):
        super().__init__()
        if mode not in EMB_MODES:  # JAX's lookup raises KeyError
            raise KeyError(f"unknown embedding mode {mode} "
                           f"(modes: {sorted(EMB_MODES)})")
        if in_norm_features:
            self.norm = DataNorm(in_norm_features)
        num_layers, kernels, residual = EMB_MODES[mode]
        self.num_layers, self.residual = num_layers, residual
        self.res_names: List[str] = []
        c = in_channels
        for i, k in enumerate(kernels):
            self.add_module(f"cnn{i + 1}", ConvNormAct(
                c, out_channels, k, k // 2, use_bias=use_bias))
            if residual == 1 and c != out_channels:
                self.add_module(f"res{i + 1}", nn.utils.skip_init(
                    nn.Linear, c, out_channels, bias=use_bias))
                self.res_names.append(f"res{i + 1}")
            c = out_channels

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_layers):
            getattr(self, f"cnn{i + 1}").reset_parameters(generator)
        for name in self.res_names:
            res = getattr(self, name)
            init.torch_default(res.in_features)(res.weight, generator)
            if res.bias is not None:
                with torch.no_grad():
                    res.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "norm"):
            x = self.norm(x)
        for i in range(self.num_layers):
            y = getattr(self, f"cnn{i + 1}")(x)
            if self.residual == 1:
                res = getattr(self, f"res{i + 1}", None)
                y = y + (x if res is None else res(x))
            x = y
        return x


class OneHot(nn.Module):
    """The reference's one-hot constant (blocks/semantic.py:128-146):
    eye(E) tiled to (1, L, E, E), then permuted to its (N, C, V, T)
    layout by `mode` (0: joints, 1: frames; 2, the class table, as
    tiled); `table()` gives it channels-last, (1, T, V, E). A table the
    reference has no buffer for is not `persistent` (no state-dict key)."""

    def __init__(self, dim_eye: int, dim_length: int, mode: int,
                 persistent: bool = True):
        super().__init__()
        oh = np.broadcast_to(np.eye(dim_eye, dtype=np.float32),
                             (1, dim_length, dim_eye, dim_eye))
        if mode == 0:
            oh = oh.transpose(0, 3, 2, 1)
        elif mode == 1:
            oh = oh.transpose(0, 3, 1, 2)
        self.register_buffer("onehot", torch.from_numpy(
            np.array(oh, order="C")), persistent=persistent)

    def table(self) -> torch.Tensor:
        return self.onehot.permute(0, 3, 2, 1)


#: NTU-25 body-part groups of the segment embedding (reference
#: blocks/feature_extractor.py:11-19; agcn_tpu sgn.py:165-169)
SEGMENTS = ((2, 3), (0, 1, 20), (4, 5, 6), (8, 9, 10),
            (16, 17, 18, 19), (12, 13, 14, 15), (7, 21, 22), (11, 23, 24))
SEGMENT_PERIOD = 4


class SegmentEmbedding(nn.ModuleList):
    """Body-part segment embedding (reference blocks/feature_extractor.py:
    23-70, engaged when input_position and input_velocity exceed 1000;
    agcn_tpu sgn.py:172-200): each (part, window of SEGMENT_PERIOD frames)
    token flattens (window position, joint, channel) into one vector,
    embedded by its part's own `SGNEmbedding` (mode % 1000, a DataNorm of
    the part's width first); the frames past the last whole window are
    dropped. Takes (B, T, 25, C), gives (B, T // 4, 8, out_channels). A
    ModuleList, so the parts' keys are the reference's `<name>.{i}.*`."""

    def __init__(self, in_channels: int, out_channels: int, mode: int,
                 use_bias: bool = True):
        super().__init__(
            SGNEmbedding(SEGMENT_PERIOD * len(seg) * in_channels,
                         out_channels, mode % 1000, use_bias,
                         in_norm_features=SEGMENT_PERIOD * len(seg)
                         * in_channels)
            for seg in SEGMENTS)
        for i, seg in enumerate(SEGMENTS):
            self.register_buffer(f"joints{i}", torch.tensor(seg),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for emb in self:
            emb.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _, c = x.shape
        tw = t // SEGMENT_PERIOD
        outs = []
        for i, emb in enumerate(self):
            xs = x[:, :tw * SEGMENT_PERIOD].index_select(
                2, getattr(self, f"joints{i}"))
            outs.append(emb(xs.reshape(b, tw, 1, -1)))
        return torch.cat(outs, dim=2)


def _blend(g: torch.Tensor, g_prior: Optional[torch.Tensor],
           alpha: torch.Tensor) -> torch.Tensor:
    """The previous unit's G blended in (`sgcn_g_weighted`, agcn_tpu
    sgn.py:229-231): (g_prior alpha + g) / (alpha + 1)."""
    return g if g_prior is None else (g_prior * alpha + g) / (alpha + 1)


def _g_projections(module: nn.Module, in_features: int, proj_dim: int,
                   names: Sequence[str], use_bias: bool,
                   g_kernel: int) -> None:
    """The G module's projections, each a conv over T of `g_kernel`
    (`sgcn_g_kernel`, padding g_kernel // 2) without norm or relu."""
    module.names = tuple(names)
    for name in names:
        module.add_module(name, ConvNormAct(
            in_features, proj_dim, g_kernel, g_kernel // 2,
            use_bias=use_bias, use_act=False))


class GCNSpatialG(nn.Module):
    """Per-frame attention G = act(g1 g2^T) (blocks/spatial.py:193-240,
    gt_mode 0; agcn_tpu sgn.py:203-235): a softmax over the source joint,
    a sigmoid, or (any other `activation`) the logits themselves; with a
    prior G, blended in through `alpha`. Returns (G, None)."""

    def __init__(self, in_features: int, proj_dim: int,
                 use_bias: bool = True, proj_shared: bool = False,
                 activation: str = "softmax", g_kernel: int = 1):
        super().__init__()
        _g_projections(self, in_features, proj_dim,
                       ("g1",) if proj_shared else ("g1", "g2"), use_bias,
                       g_kernel)
        self.activation = (activation if activation in ("softmax", "sigmoid")
                           else "identity")
        self.alpha = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.names:
            getattr(self, name).reset_parameters(generator)
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor,
                g_prior: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        g1 = self.g1(x)
        g2 = g1 if len(self.names) == 1 else self.g2(x)
        return _blend(frame_attention(g1, g2, self.activation), g_prior,
                      self.alpha), None


class GCNSpatialGT(nn.Module):
    """G mixed through a T x T temporal attention (blocks/spatial.py:243-322,
    gt_mode 1; agcn_tpu sgn.py:238-279): g12 = g1 g2^T per frame, the frame
    descriptors are the joint-max of g3 and g4, g34 = softmax_j(g3p g4p^T)
    mixes the frames' g12, then a softmax over the source joint (or a
    sigmoid, gt_activation 2); with a prior G, blended in through
    `alpha`. Returns (G, None): this mode gives the unit no per-frame
    gate."""

    def __init__(self, in_features: int, proj_dim: int,
                 use_bias: bool = True, proj_shared: bool = False,
                 gt_activation: int = 1, g_kernel: int = 1):
        super().__init__()
        self.proj_shared = proj_shared
        self.gt_activation = gt_activation
        _g_projections(self, in_features, proj_dim,
                       ("g1", "g3") if proj_shared
                       else ("g1", "g2", "g3", "g4"), use_bias, g_kernel)
        self.alpha = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.names:
            getattr(self, name).reset_parameters(generator)
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor,
                g_prior: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        b, t, v, _ = x.shape
        g1, g3 = self.g1(x), self.g3(x)
        g2, g4 = (g1, g3) if self.proj_shared else (self.g2(x), self.g4(x))
        g12 = frame_attention(g1, g2, "identity")  # (B, T, V, V)
        g3p = torch.amax(g3, dim=2)  # (B, T, C)
        g4p = torch.amax(g4, dim=2)
        g34 = torch.softmax(torch.matmul(g3p, g4p.transpose(1, 2)), dim=-1)
        g12 = torch.matmul(g34, g12.reshape(b, t, v * v)).reshape(b, t, v, v)
        g12 = (torch.softmax(g12, dim=-1) if self.gt_activation == 1
               else torch.sigmoid(g12))
        return _blend(g12, g_prior, self.alpha), None


class FrameScalarMLP(nn.Module):
    """One scalar a frame from its flattened joint features (the
    reference's MLPTemporal in GCNSpatialGT3 / GT4, blocks/spatial.py:
    391-545; agcn_tpu sgn.py:282-303): `depth` - 1 layers conv k3 -> BN ->
    relu of `hidden` channels, then a 1x1 conv to one channel. Takes
    (B, T, 1, C*V) and gives (B, T)."""

    def __init__(self, in_features: int, hidden: int, depth: int = 2,
                 use_bias: bool = True):
        super().__init__()
        self.depth = depth
        c = in_features
        for i in range(depth - 1):
            self.add_module(f"cnn{i + 1}", ConvNormAct(
                c, hidden, 3, 1, use_bias=use_bias, use_norm=True))
            c = hidden
        self.add_module(f"cnn{depth}", ConvNormAct(c, 1, use_bias=use_bias,
                                                   use_act=False))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.depth):
            getattr(self, f"cnn{i + 1}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"cnn{i + 1}")(x)
        return x[..., 0, 0]


class GCNSpatialGTScalar(nn.Module):
    """GT modes 2, 3 and 4 (blocks/spatial.py GCNSpatialGT2 :325-388, GT3
    :391-467, GT4 :470-545; agcn_tpu sgn.py:311-365): G = act(g1 g2^T) per
    frame (a softmax over the source joint for `activation` 'softmax',
    else a sigmoid), and a per-frame scalar s of the frame's flattened
    joint features: GT2 the Linear `g3`, GT3 / GT4 the MLP `g3` (C*V or C
    hidden channels, `g3_idx` layers), then a softmax over the frames (a
    sigmoid for gt_activation 2). GT2 and GT3 return (s G, s), with a
    prior G blended in through `alpha`; GT4 (G, s) for the unit to gate
    its input. `g3` reads the features in the reference's (c, v) order,
    so its weights are the reference's."""

    def __init__(self, in_features: int, num_point: int, proj_dim: int,
                 gt_mode: int = 2, use_bias: bool = True,
                 proj_shared: bool = False, activation: str = "softmax",
                 gt_activation: int = 1, g3_idx: int = 2, g_kernel: int = 1):
        super().__init__()
        self.gt_mode = gt_mode
        self.activation = "softmax" if activation == "softmax" else "sigmoid"
        self.gt_activation = gt_activation
        _g_projections(self, in_features, proj_dim,
                       ("g1",) if proj_shared else ("g1", "g2"), use_bias,
                       g_kernel)
        flat = in_features * num_point
        if gt_mode == 2:
            self.g3 = nn.utils.skip_init(nn.Linear, flat, 1, bias=use_bias)
        else:
            self.g3 = FrameScalarMLP(
                flat, flat if gt_mode == 3 else in_features, g3_idx,
                use_bias)
        self.alpha = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.names:
            getattr(self, name).reset_parameters(generator)
        if isinstance(self.g3, nn.Linear):
            init.torch_default(self.g3.in_features)(self.g3.weight, generator)
            if self.g3.bias is not None:
                with torch.no_grad():
                    self.g3.bias.zero_()
        else:
            self.g3.reset_parameters(generator)
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor,
                g_prior: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, v, c = x.shape
        g1 = self.g1(x)
        g2 = g1 if len(self.names) == 1 else self.g2(x)
        g12 = frame_attention(g1, g2, self.activation)
        flat = x.transpose(2, 3).reshape(b, t, 1, c * v)  # (c, v) order
        s = self.g3(flat)
        if self.gt_mode == 2:
            s = s[..., 0, 0]
        s = (torch.softmax(s, dim=-1) if self.gt_activation == 1
             else torch.sigmoid(s))[:, :, None, None]  # (B, T, 1, 1)
        if self.gt_mode == 4:
            return g12, s
        return _blend(s * g12, g_prior, self.alpha), s


class MLPTemporal(nn.Module):
    """GT5's head `g3` (the reference MLPTemporal, blocks/temporal.py:
    99-161; agcn_tpu sgn.py:408-418): `depth` layers conv -> BN -> relu of
    `features` channels, kernel 3 (the last 1), with Dropout2d 0.5 after
    the first."""

    def __init__(self, in_features: int, features: int, depth: int = 2,
                 use_bias: bool = True):
        super().__init__()
        self.depth = depth
        c = in_features
        for i in range(depth):
            k = 3 if i < depth - 1 else 1
            self.add_module(f"cnn{i + 1}", ConvNormAct(
                c, features, k, k // 2, use_bias=use_bias, use_norm=True,
                dropout=0.5 if i == 0 else 0.0))
            c = features

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.depth):
            getattr(self, f"cnn{i + 1}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"cnn{i + 1}")(x)
        return x


class GCNSpatialGTMap(nn.Module):
    """GT modes 5 and 6 (blocks/spatial.py GCNSpatialGT5 :547-632, GT6
    :633-700; agcn_tpu sgn.py:368-420): G = act(g1 g2^T) per frame (a
    softmax over the source joint for `activation` 'softmax', else a
    sigmoid), and a second output, each frame's flattened V x V map plus
    the one-hot frame embedding `tem_embedding` (of the buffer
    `tem_onehot`, (1, T, 1, T)), (B, T, 1, V*V); GT5 puts it through the
    head `g3` (`MLPTemporal` of `out_channels2`, `g3_idx` layers). A
    prior G is not read, as in JAX; `alpha` exists and is not used."""

    def __init__(self, in_features: int, num_point: int, num_segment: int,
                 proj_dim: int, gt_mode: int = 5, out_channels2: int = 512,
                 use_bias: bool = True, proj_shared: bool = False,
                 activation: str = "softmax", g3_idx: int = 2,
                 g_kernel: int = 1):
        super().__init__()
        self.activation = "softmax" if activation == "softmax" else "sigmoid"
        _g_projections(self, in_features, proj_dim,
                       ("g1",) if proj_shared else ("g1", "g2"), use_bias,
                       g_kernel)
        vv = num_point * num_point
        self.tem_embedding = SGNEmbedding(num_segment, vv, 1, use_bias)
        self.tem_onehot = OneHot(num_segment, 1, mode=1)
        if gt_mode == 5:
            self.g3 = MLPTemporal(vv, out_channels2, g3_idx, use_bias)
        self.out_features = out_channels2 if gt_mode == 5 else vv
        self.alpha = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.names:
            getattr(self, name).reset_parameters(generator)
        self.tem_embedding.reset_parameters(generator)
        if hasattr(self, "g3"):
            self.g3.reset_parameters(generator)
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor,
                g_prior: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del g_prior
        b, t, v, _ = x.shape
        g1 = self.g1(x)
        g2 = g1 if len(self.names) == 1 else self.g2(x)
        g12 = frame_attention(g1, g2, self.activation)
        # channel (i, j) of a frame's map: the reference's rearrange
        # 'n t i j -> n (i j) t' (spatial.py:624-626)
        y = g12.reshape(b, t, 1, v * v) + self.tem_embedding(
            self.tem_onehot.table())
        return g12, (self.g3(y) if hasattr(self, "g3") else y)


# the attn modes of a unit (agcn_tpu sgn.py:475-499): 0 G-aggregate, 1 no
# G, 2 squeeze-excite, 3 w2 alone, 10 mode 0 with w2 on the injected level
ATTN_MODES = (0, 1, 2, 3, 10)


class GCNSpatialUnit(nn.Module):
    """One SGN graph conv (blocks/spatial.py:702-843; agcn_tpu
    sgn.py:423-506): by `attn_mode`, 0 w1(G x0) + res_alpha w2(x); 1
    w1(x0) + res_alpha w2(x); 2 sigmoid(w1(relu(w3(mean_v x0)))) +
    res_alpha w2(x) (`w3` of out / 2 channels); 3 w2(x); 10 mode 0 with
    w2 reading the injected level `y` where one is given (the second
    stack); then norm (none under `prenorm`) -> relu -> dropout2d. x0 is x,
    or `w0(x)`, a conv over T of `v_kernel` (> 0); w2 is a conv over T of
    `kernel_size` and `padding`. w1's kernel starts at zero (the
    reference's init_weight, sgn_v14.py:817-827), so a fresh model's G
    path adds exactly zero. `res_alpha` is a fixed float, or the
    learnable `res_alpha` for -1 (starting at one) and -2 (at zero). Under
    gt_mode 4 the G module's per-frame scalar gates x before both paths.
    `y_features`: the injected level's width (w2's input under mode 10)."""

    def __init__(self, in_features: int, out_channels: int,
                 use_bias: bool = True, dropout: float = 0.0,
                 prenorm: bool = False, res_alpha: float = 1.0,
                 gt_mode: int = 1, attn_mode: int = 0, kernel_size: int = 1,
                 padding: int = 0, v_kernel: int = 0,
                 y_features: Optional[int] = None):
        super().__init__()
        if attn_mode not in ATTN_MODES:
            raise NotImplementedError(f"attn_mode {attn_mode}")
        self.attn_mode = attn_mode
        if v_kernel > 0:
            self.w0 = ConvNormAct(in_features, in_features, v_kernel,
                                  v_kernel // 2, use_bias=use_bias,
                                  use_act=False)
        if attn_mode != 3:
            self.w1 = ConvNormAct(
                out_channels // 2 if attn_mode == 2 else in_features,
                out_channels, use_bias=use_bias, use_act=False)
        if attn_mode == 2:
            self.w3 = ConvNormAct(in_features, out_channels // 2,
                                  use_bias=use_bias, use_act=False)
        self.reads_y = attn_mode == 10 and y_features is not None
        self.w2 = ConvNormAct(y_features if self.reads_y else in_features,
                              out_channels, kernel_size, padding,
                              use_bias=use_bias, use_act=False)
        if not prenorm:
            self.norm = BatchNorm(out_channels)
        self.drop = Dropout(dropout, (1, 2)) if dropout > 0.0 else None
        self.gate = gt_mode == 4
        self.alpha_init = {-1: 1.0, -2: 0.0}.get(res_alpha)
        if self.alpha_init is not None:
            self.res_alpha = nn.Parameter(torch.full((1,), self.alpha_init))
        else:
            self.fixed_alpha = float(res_alpha)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if hasattr(self, "w0"):
            self.w0.reset_parameters(generator)
        if hasattr(self, "w1"):
            self.w1.reset_parameters(generator, kernel=init.constant(0.0))
        self.w2.reset_parameters(generator)
        if hasattr(self, "w3"):
            self.w3.reset_parameters(generator)
        if self.alpha_init is not None:
            with torch.no_grad():
                self.res_alpha.fill_(self.alpha_init)

    def _w2(self, x: torch.Tensor) -> torch.Tensor:
        y2 = self.w2(x)
        if self.alpha_init is not None:
            return y2 * self.res_alpha
        return y2 if self.fixed_alpha == 1.0 else y2 * self.fixed_alpha

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor],
                s: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.gate and s is not None:
            x = s * x
        x0 = self.w0(x) if hasattr(self, "w0") else x
        mode = self.attn_mode
        if mode in (0, 10):
            z = self.w1(frame_aggregate(x0, g)) + self._w2(
                y if self.reads_y and y is not None else x)
        elif mode == 1:
            z = self.w1(x0) + self._w2(x)
        elif mode == 2:
            se = torch.relu(self.w3(x0.mean(dim=2, keepdim=True)))
            z = torch.sigmoid(self.w1(se)) + self._w2(x)
        else:
            z = self.w2(x)
        if hasattr(self, "norm"):
            z = self.norm(z)
        z = torch.relu(z)
        return z if self.drop is None else self.drop(z)


def ffn_variant(ffn: float) -> Tuple[int, float]:
    """`sgcn_ffn` -> (variant, multiplier): divmod(ffn, 100), the whole
    value the multiplier of variant 0 (agcn_tpu sgn.py:623-627); variants
    1 and 3 are post-norm, 2 and 3 the reference's "Linear" FFNs."""
    variant, multiplier = divmod(float(ffn), 100.0)
    return int(variant), float(ffn) if int(variant) == 0 else multiplier


def linear_ffn_stacks(model_args: Dict[str, Any]) -> Tuple[str, ...]:
    """The stacks ("sgcn", "sgcn2") of these SGN `model_args` whose FFN is
    a "Linear" variant: the weight map's `linear_ffn`."""
    return tuple(s for s in ("sgcn", "sgcn2")
                 if model_args.get(f"{s}_ffn") is not None
                 and ffn_variant(model_args[f"{s}_ffn"])[0] in (2, 3))


class GCNSpatialFFN(nn.Module):
    """The unit's FFN with its residual (blocks/spatial.py:36-117; agcn_tpu
    sgn.py:509-533): x + ffn2(ffn1(x)), each conv -> [BN] -> relu, ffn1 to
    int(C multiplier) channels; post-norm moves the BN to `norm`, after the
    residual. The "Linear" variants (2xx, 3xx) hold `LinearLayer`s, which
    compute what the 1x1 convs do, under the reference's names."""

    def __init__(self, features: int, multiplier: float = 4.0,
                 use_bias: bool = True, postnorm: bool = False,
                 linear: bool = False):
        super().__init__()
        inter = int(features * multiplier)
        self.ffn1 = ConvNormAct(features, inter, use_bias=use_bias,
                                use_norm=not postnorm, linear=linear)
        self.ffn2 = ConvNormAct(inter, features, use_bias=use_bias,
                                use_norm=not postnorm, linear=linear)
        if postnorm:
            self.norm = BatchNorm(features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ffn1.reset_parameters(generator)
        self.ffn2.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ffn2(self.ffn1(x)) + x
        return self.norm(y) if hasattr(self, "norm") else y


class GCNSpatialBlock(nn.Module):
    """The GCN units `gcn1..N` (blocks/spatial.py:846-1013; agcn_tpu
    sgn.py:536-633), each after its BN `gcn_prenorm{i}` (`prenorm`: the G
    module and the unit read the normalized input, the residual the raw
    one), and followed by `residual[i]` (the input added, through the 1x1
    conv `gcn_res{i}` where the widths differ) and the FFN `gcn_ffn{i}`
    (`ffn`, see `ffn_variant`). G comes from one G module `gcn_g1` shared
    by every unit when `g_proj_dim` is an int, or one `gcn_g{i}` a unit
    for a list (with `g_weighted` each blended with the previous unit's
    G): `GCNSpatialG` (gt_mode 0), `GCNSpatialGT` (1), `GCNSpatialGTScalar`
    (2-4) or `GCNSpatialGTMap` (5, 6), its projections convs over T of
    `g_kernel`. Given `y_features` (the second stack, GCNSpatialBlock2,
    spatial.py:1017+) the block builds no G module: its forward takes
    `g_fixed` for every unit and the injected levels `inject`, of these
    widths, which attn_mode 10's w2 reads."""

    def __init__(self, in_features: int, dims: Sequence[int],
                 g_proj_dim: Union[int, Sequence[int]] = 256,
                 g_proj_shared: bool = False, g_kernel: int = 1,
                 kernel_size: int = 1, padding: int = 0, v_kernel: int = 0,
                 g_activation: str = "softmax", g_weighted: bool = False,
                 gt_mode: int = 1, gt_act: int = 1, res_alpha: float = 1.0,
                 residual: Optional[Sequence[int]] = None,
                 prenorm: bool = False, ffn: Optional[float] = None,
                 dropout: float = 0.0, use_bias: bool = True,
                 attn_mode: int = 0, gt_out_channels2: int = 512,
                 g3_idx: int = 2, num_point: int = 25,
                 num_segment: int = 20,
                 y_features: Optional[Sequence[int]] = None):
        super().__init__()
        if gt_mode not in (0, 1, 2, 3, 4, 5, 6):
            raise NotImplementedError(f"gt_mode {gt_mode}")
        self.dims = tuple(dims)
        self.g_shared = isinstance(g_proj_dim, int)
        self.g_weighted = g_weighted and not self.g_shared
        self.fixed_g = y_features is not None
        self.residual = (tuple(int(r) for r in residual)
                         if residual is not None else (0,) * len(self.dims))
        self.prenorm = prenorm
        ffn_mode = None if ffn is None else ffn_variant(ffn)
        self.g_out_features = None
        c = in_features
        for i, dim in enumerate(self.dims):
            if prenorm:
                self.add_module(f"gcn_prenorm{i + 1}", BatchNorm(c))
            if not self.fixed_g and (i == 0 or not self.g_shared):
                proj = g_proj_dim if self.g_shared else g_proj_dim[i]
                common = dict(use_bias=use_bias, proj_shared=g_proj_shared,
                              g_kernel=g_kernel)
                if gt_mode == 0:
                    g_mod = GCNSpatialG(c, proj, activation=g_activation,
                                        **common)
                elif gt_mode == 1:
                    g_mod = GCNSpatialGT(c, proj, gt_activation=gt_act,
                                         **common)
                elif gt_mode in (2, 3, 4):
                    g_mod = GCNSpatialGTScalar(
                        c, num_point, proj, gt_mode,
                        activation=g_activation, gt_activation=gt_act,
                        g3_idx=g3_idx, **common)
                else:
                    g_mod = GCNSpatialGTMap(
                        c, num_point, num_segment, proj, gt_mode,
                        gt_out_channels2, activation=g_activation,
                        g3_idx=g3_idx, **common)
                    if i == 0:
                        self.g_out_features = g_mod.out_features
                self.add_module(f"gcn_g{i + 1}", g_mod)
            self.add_module(f"gcn{i + 1}", GCNSpatialUnit(
                c, dim, use_bias=use_bias, dropout=dropout, prenorm=prenorm,
                res_alpha=res_alpha, gt_mode=gt_mode, attn_mode=attn_mode,
                kernel_size=kernel_size, padding=padding, v_kernel=v_kernel,
                y_features=None if y_features is None else y_features[i]))
            if self.residual[i] == 1 and c != dim:
                self.add_module(f"gcn_res{i + 1}", ConvNormAct(
                    c, dim, use_bias=use_bias, use_act=False))
            if ffn_mode is not None:
                self.add_module(f"gcn_ffn{i + 1}", GCNSpatialFFN(
                    dim, ffn_mode[1], use_bias, postnorm=ffn_mode[0] in (1, 3),
                    linear=ffn_mode[0] in (2, 3)))
            c = dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(len(self.dims)):
            for name in (f"gcn_g{i + 1}", f"gcn{i + 1}", f"gcn_res{i + 1}",
                         f"gcn_ffn{i + 1}"):
                if hasattr(self, name):
                    getattr(self, name).reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                inject: Optional[Sequence[torch.Tensor]] = None,
                g_fixed: Optional[torch.Tensor] = None):
        """(the last unit's output, the list of (G, the G module's second
        output), every unit's output)."""
        g_list: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        x_list: List[torch.Tensor] = []
        for i in range(len(self.dims)):
            x1 = getattr(self, f"gcn_prenorm{i + 1}")(x) if self.prenorm \
                else x
            if self.fixed_g:
                if not g_list:
                    g_list.append((g_fixed, None))
            elif i == 0 or not self.g_shared:
                g_prior = g_list[-1][0] if self.g_weighted and g_list \
                    else None
                g_list.append(getattr(self, f"gcn_g{i + 1}")(x1, g_prior))
            g, s = g_list[-1]
            z = getattr(self, f"gcn{i + 1}")(
                x1, g, s, None if inject is None else inject[i])
            if self.residual[i] == 1:
                res = getattr(self, f"gcn_res{i + 1}", None)
                z = z + (x if res is None else res(x))
            x = z
            ffn = getattr(self, f"gcn_ffn{i + 1}", None)
            if ffn is not None:
                x = ffn(x)
            x_list.append(x)
        return x, g_list, x_list


class TemporalBranchMLP(nn.Module):
    """Two-layer temporal conv MLP (blocks/temporal.py:99-160; agcn_tpu
    sgn.py:636-676): [a VALID max pool over time, `maxpool_kwargs`' last
    kernel and stride elements], conv k -> BN -> relu -> dropout2d
    (`cnn1`), then 1x1 -> BN -> relu (`cnn2`), each BN before its conv
    under `prenorm`; t_mode 2 adds each layer's input to its output,
    through the 1x1 conv `res2` where cnn2 changes the width."""

    def __init__(self, in_features: int, out_channels: int,
                 kernel_size: int = 3, dropout: float = 0.0,
                 use_bias: bool = True, t_mode: int = 1,
                 maxpool_kwargs: Optional[dict] = None,
                 prenorm: bool = False):
        super().__init__()
        self.residual = t_mode == 2
        self.pool = None
        if maxpool_kwargs:
            ks = maxpool_kwargs.get("kernel_size", [1, 1])
            st = maxpool_kwargs.get("stride", ks)
            self.pool = tuple(int(v[-1] if isinstance(v, (list, tuple))
                                  else v) for v in (ks, st))
        self.cnn1 = ConvNormAct(in_features, in_features, kernel_size,
                                kernel_size // 2, use_bias=use_bias,
                                use_norm=True, dropout=dropout,
                                prenorm=prenorm)
        self.cnn2 = ConvNormAct(in_features, out_channels,
                                use_bias=use_bias, use_norm=True,
                                prenorm=prenorm)
        if self.residual and in_features != out_channels:
            self.res2 = Conv1xN(in_features, out_channels,
                                use_bias=use_bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cnn1.reset_parameters(generator)
        self.cnn2.reset_parameters(generator)
        if hasattr(self, "res2"):
            self.res2.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool is not None:  # VALID, over time
            x = F.max_pool2d(x.permute(0, 3, 1, 2), (self.pool[0], 1),
                             (self.pool[1], 1)).permute(0, 2, 3, 1)
        y = self.cnn1(x)
        if not self.residual:
            return self.cnn2(y)
        y = y + x
        z = self.cnn2(y)
        return z + (self.res2(y) if hasattr(self, "res2") else y)


class TemporalBranch(nn.Module):
    """A temporal branch (blocks/temporal.py:274-397; agcn_tpu
    sgn.py:679-755): [`aspp`, an `ASPP` of the input's width], then by
    `t_mode`: 0 the feature itself (no parameters); 1 and 2 the MLP `cnn`
    (2 with residuals; `maxpool_kwargs` pools first); 3 the encoder `mha`
    (`ops/attention.TransformerEncoder`) over the T tokens of V C
    features, as (B, T, 1, V C), its position table `num_segment` long;
    4 `SeriesDecomposition`, then t_mode-2 MLPs `cnn_raw`, `cnn_season`
    and `cnn_trend` over x, its seasonal part and its trend; 5 a t_mode-2
    MLP of kernel 1 `cnn_p{k}` over each replicate-padded moving average of
    `pool_kernel_sizes`; every MLP's BNs before their convs under
    `prenorm`. Returns the list of outputs, each of `out_shape`.
    `in_features` is the input's channels and `joints` its V: 1 for a
    spatially pooled level."""

    def __init__(self, in_features: int, out_channels: int,
                 kernel_size: int = 3, dropout: float = 0.0,
                 use_bias: bool = True, t_mode: int = 1,
                 aspp_rates: Optional[Sequence[int]] = None,
                 mha_kwargs: Optional[dict] = None,
                 maxpool_kwargs: Optional[dict] = None,
                 decomp_kernel_size: int = 3,
                 pool_kernel_sizes: Sequence[int] = (3, 5, 7, 9),
                 num_segment: int = 20, prenorm: bool = False,
                 joints: int = 1):
        super().__init__()
        if t_mode not in (0, 1, 2, 3, 4, 5):
            raise NotImplementedError(f"t_mode {t_mode}")
        self.in_features = in_features
        self.t_mode = t_mode
        if aspp_rates:
            self.aspp = ASPP(in_features, in_features, tuple(aspp_rates),
                             use_bias=bool(use_bias))
        if t_mode in (1, 2):
            self.cnn = TemporalBranchMLP(in_features, out_channels,
                                         kernel_size, dropout, use_bias,
                                         t_mode, maxpool_kwargs, prenorm)
        elif t_mode == 3:
            kw = dict(mha_kwargs or {})
            nhead, dff = kw.get("nhead", 1), kw.get("dim_feedforward", 256)
            self.mha = TransformerEncoder(
                in_features * joints, kw.get("num_layers", 1),
                nhead[0] if isinstance(nhead, (list, tuple)) else nhead,
                dff[0] if isinstance(dff, (list, tuple)) else dff,
                dropout=kw.get("dropout", 0.1),
                activation=kw.get("activation", "relu"),
                pos_enc=kw.get("pos_enc"), max_len=num_segment)
        elif t_mode == 4:
            self.decomp = SeriesDecomposition(decomp_kernel_size)
            for part in ("raw", "season", "trend"):
                self.add_module(f"cnn_{part}", TemporalBranchMLP(
                    in_features, out_channels, kernel_size, dropout,
                    use_bias, t_mode=2, prenorm=prenorm))
        elif t_mode == 5:
            self.pool_kernel_sizes = tuple(int(k) for k in pool_kernel_sizes)
            for k in self.pool_kernel_sizes:
                self.add_module(f"cnn_p{k}", TemporalBranchMLP(
                    in_features, out_channels, 1, dropout, use_bias,
                    t_mode=2, prenorm=prenorm))
        frames = num_segment
        if t_mode in (1, 2) and self.cnn.pool is not None:  # VALID
            frames = (num_segment - self.cnn.pool[0]) // self.cnn.pool[1] + 1
        # (T', V', C') of each output
        self.out_shape = ((frames, joints, in_features) if t_mode == 0
                          else (frames, 1, in_features * joints)
                          if t_mode == 3 else (frames, joints, out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if hasattr(self, "aspp"):
            x = self.aspp(x)
        if self.t_mode == 0:
            return [x]
        if self.t_mode in (1, 2):
            return [self.cnn(x)]
        if self.t_mode == 3:
            b, t, v, c = x.shape
            y, _ = self.mha(x.reshape(b, t, v * c))
            return [y.reshape(b, t, 1, -1)]
        if self.t_mode == 4:
            seasonal, trend = self.decomp(x)
            return [self.cnn_raw(x), self.cnn_season(seasonal),
                    self.cnn_trend(trend)]
        return [getattr(self, f"cnn_p{k}")(moving_average(x, k))
                for k in self.pool_kernel_sizes]


# the GCN-FPN's projection modes (agcn_tpu sgn.py:964-1007): mode -> the
# projections' width from sgcn_dims (mode 6: 64) and whether level i sums
# the projections of levels i.. (1, 2, 6, 7, 9), keeps its own (3), or the
# pooled levels are concatenated into the last one (4, 5)
_FPN_WIDTH = {1: lambda d: d[-1], 2: lambda d: d[0], 3: lambda d: d[-1],
              4: lambda d: d[-1], 5: lambda d: d[-1] // 4, 6: lambda d: 64,
              7: lambda d: d[-1], 9: lambda d: d[-1]}
_FPN_SUM = (1, 2, 6, 7, 9)
_FPN_CONCAT = (4, 5)

# the pooling modes (agcn_tpu sgn.py:1056-1097, 1177-1216): 0 none, 1 the
# max, 2 (temporal) the max plus `tmp_ind_projection` of the argmax, 3-5
# conv -> BN -> relu layers in this order: "k" a VALID conv over every
# joint (spatial) or every frame (temporal), "1x1" a 1x1 conv
SPATIAL_POOLS = (0, 1, 3, 4, 5)
TEMPORAL_POOLS = (0, 1, 2, 3, 4, 5)
_POOL_LAYERS = {3: ("k",), 4: ("1x1", "k"), 5: ("k", "1x1")}


def latent_noise(shape: Sequence[int], generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """eps of the InfoGCN head's train-time draw: a standard normal from
    the model's dropout generator. `tools/grad_parity.NoiseProbe` stands in
    for it to record one run's draws and replay them in another."""
    return torch.randn(tuple(shape), generator=generator, device=device)


def _pool_conv(in_features: int, features: int, kernel: Tuple[int, int],
               use_bias: bool) -> nn.Conv2d:
    """A pooling conv over the (T, V) grid, the JAX module's kernel as
    torch's (out, in, kT, kV)."""
    return nn.utils.skip_init(nn.Conv2d, in_features, features, kernel,
                              bias=use_bias)


class SGN(nn.Module):
    """The SGN classifier (agcn_tpu sgn.py:758-1283) at every option of
    the JAX model. `forward(x)` takes (B, num_segment, V*C) and returns
    the logits;
    `forward(x, return_g=True)` returns (logits, the list of G, each
    (B, T, V, V)).

    Built on the CPU, initialized from `generator` (seed 0 when None) and
    moved to `device`, `cuda` unless the caller names another. The
    dropouts (dropout2d in the temporal branches, `sgcn_dropout` and
    `sgcn2_dropout` in the units, GT5's head's 0.5, the temporal
    encoder's under t_mode 3, `dropout` before fc) and the InfoGCN head's
    eps draw from one generator on that device, seeded from `generator`
    (`dropout_seed`; the train step reseeds it for each update,
    `train/steps.seed_dropout`). Parameters and compute are fp32.

    `has_aux`: the train and eval steps call `forward(x, return_aux=True)`
    for an aux loss (only models that set it take the argument)."""

    has_aux = True

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_segment: int = 20, in_channels: int = 3,
                 use_bias: bool = True, dropout: float = 0.0,
                 dropout2d: float = 0.0,
                 c_multiplier: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 input_position: int = 1, input_velocity: int = 1,
                 semantic_joint: int = 1, semantic_frame: int = 1,
                 semantic_class: int = 0, semantic_jdiff: int = 0,
                 semantic_joint_smp: int = 0, semantic_joint_fusion: int = 0,
                 semantic_frame_location: int = 0, xem_projection: int = 0,
                 sgcn_dims: Optional[Sequence[int]] = None,
                 sgcn_residual: Sequence[int] = (0, 0, 0),
                 sgcn_prenorm: bool = False,
                 sgcn_ffn: Optional[float] = None, sgcn_dropout: float = 0.0,
                 sgcn_g_proj_dim: Optional[Any] = None,
                 sgcn_g_proj_shared: bool = False,
                 sgcn_g_activation: str = "softmax",
                 sgcn_g_weighted: bool = False, sgcn_g_res_alpha: float = 1.0,
                 sgcn_kernel: int = 1, sgcn_padding: int = 0,
                 sgcn_g_kernel: int = 1, sgcn_v_kernel: int = 0,
                 sgcn_gt_mode: int = 1, sgcn_gt_act: int = 1,
                 sgcn_gt_g3_idx: int = 2, sgcn_gt_out_channels2: int = 512,
                 sgcn_attn_mode: int = 0, gcn_fpn_output_merge: int = 1,
                 gcn_fpn_shared: int = 0, gcn_fpn: int = -1,
                 sgcn2_dims: Optional[Sequence[int]] = None,
                 sgcn2_kernel: int = 1, sgcn2_padding: int = 0,
                 sgcn2_dropout: float = 0.0,
                 sgcn2_residual: Optional[Sequence[int]] = None,
                 sgcn2_prenorm: bool = False,
                 sgcn2_ffn: Optional[float] = None, sgcn2_v_kernel: int = 0,
                 sgcn2_attn_mode: int = 0,
                 gcn_fpn_kernel: int = 1, bifpn_dim: int = 256,
                 bifpn_layers: int = 1,
                 spatial_maxpool: int = 1, temporal_maxpool: int = 1,
                 multi_t: Sequence[Sequence[int]] = ((), (), (3,)),
                 multi_t_shared: int = 0, t_mode: int = 1,
                 infogcn_noise_ratio: Optional[float] = None,
                 infogcn_gain: Optional[float] = None,
                 t_mha_kwargs: Optional[dict] = None,
                 t_maxpool_kwargs: Optional[dict] = None,
                 aspp_rates: Optional[Sequence[int]] = None,
                 decomp_kernel_size: int = 3,
                 pool_kernel_sizes: Sequence[int] = (3, 5, 7, 9),
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"SGN computes in fp32 (as in the JAX package); dtype "
                f"{dtype} asked")
        if gcn_fpn_output_merge == 2 and infogcn_noise_ratio is not None:
            raise ValueError(
                "gcn_fpn_output_merge=2 has per-branch classifier heads "
                "and cannot host the InfoGCN latent head")
        if spatial_maxpool not in SPATIAL_POOLS:
            raise NotImplementedError("spatial_maxpool mode")
        if temporal_maxpool not in TEMPORAL_POOLS:
            raise NotImplementedError("temporal_maxpool mode")
        if input_position <= 0 and input_velocity <= 0:
            raise ValueError("SGN needs input_position or input_velocity")
        m = (tuple(c_multiplier) if isinstance(c_multiplier, (list, tuple))
             else (c_multiplier,) * 4)
        c1, c2, c3, c4 = (int(C1 * m[0]), int(C2 * m[1]), int(C3 * m[2]),
                          int(C4 * m[3]))
        self.num_class = num_class
        self.num_point = num_point
        self.num_segment = num_segment
        self.in_channels = in_channels
        self.fusion = semantic_joint_fusion
        # the body-part segment embeddings: from there on the graph has
        # the 8 part nodes over seg // 4 windows (agcn_tpu sgn.py:860-876)
        self.segments = input_position > 1000 and input_velocity > 1000
        if self.segments and num_point != 25:
            raise ValueError(
                f"the segment embeddings group the 25 NTU joints; "
                f"num_point is {num_point}")
        v, t = ((len(SEGMENTS), num_segment // SEGMENT_PERIOD)
                if self.segments else (num_point, num_segment))

        self.feature_extractor = nn.ModuleDict()
        for name, mode in (("pos_embed", input_position),
                           ("vel_embed", input_velocity)):
            if self.segments:
                self.feature_extractor[name] = SegmentEmbedding(
                    in_channels, c1, mode, use_bias)
            elif mode > 0:
                self.feature_extractor[name] = SGNEmbedding(
                    in_channels, c1, mode, use_bias,
                    in_norm_features=in_channels * v)
        self.semantic_embedding = nn.ModuleDict()
        width = c1
        # semantic_jdiff: the joint embedding fused into the position
        # stream and `jdiff_embedding` into the velocity stream, each by
        # the fusion (agcn_tpu sgn.py:894-903)
        self.jdiff = (semantic_jdiff > 0 and semantic_joint > 0
                      and input_position > 0 and input_velocity > 0)
        if semantic_joint > 0:
            self.semantic_embedding["spa_embedding"] = SGNEmbedding(
                v, c1, semantic_joint, use_bias)
            self.semantic_embedding["spa_onehot"] = OneHot(v, t, mode=0)
            width = 2 * c1 if semantic_joint_fusion == 0 else c1
        if self.jdiff:
            self.semantic_embedding["jdiff_embedding"] = SGNEmbedding(
                v, c1, semantic_jdiff, use_bias)
        if xem_projection > 0:  # before the stack (agcn_tpu sgn.py:914-918)
            self.x_emb_projection = SGNEmbedding(width, width,
                                                 xem_projection, use_bias)
        dims = self.sgcn_dims = tuple(sgcn_dims or (c2, c3, c3))
        self.frame_first = semantic_frame_location == 1
        if semantic_frame > 0:
            # of the stack's input width when added before it, else of the
            # BiFPN's under gcn_fpn 8 (agcn_tpu sgn.py:920-936)
            self.semantic_embedding["tem_embedding"] = SGNEmbedding(
                t, width if self.frame_first
                else bifpn_dim if gcn_fpn == 8 else dims[-1],
                semantic_frame, use_bias)
            self.semantic_embedding["tem_onehot"] = OneHot(t, v, mode=1)
        if semantic_class > 0:
            # added to the pooled feature (agcn_tpu sgn.py:1218-1223)
            self.semantic_embedding["cls_embedding"] = SGNEmbedding(
                1, c4, semantic_class, use_bias)
            self.semantic_embedding["cls_onehot"] = OneHot(1, 1, mode=2)
        g_proj = sgcn_g_proj_dim if sgcn_g_proj_dim is not None else c3
        if isinstance(g_proj, (list, tuple)):
            g_proj = tuple(g_proj)
        self.gt_mode = sgcn_gt_mode
        self.sgcn = GCNSpatialBlock(
            width, dims, g_proj, bool(sgcn_g_proj_shared),
            g_kernel=sgcn_g_kernel, kernel_size=sgcn_kernel,
            padding=sgcn_padding, v_kernel=sgcn_v_kernel,
            g_activation=sgcn_g_activation, g_weighted=bool(sgcn_g_weighted),
            gt_mode=sgcn_gt_mode, gt_act=sgcn_gt_act,
            res_alpha=sgcn_g_res_alpha, residual=sgcn_residual,
            prenorm=bool(sgcn_prenorm), ffn=sgcn_ffn, dropout=sgcn_dropout,
            use_bias=use_bias, attn_mode=sgcn_attn_mode,
            gt_out_channels2=sgcn_gt_out_channels2, g3_idx=sgcn_gt_g3_idx,
            num_point=v, num_segment=t)

        # the GCN-FPN: the levels that feed the temporal branches, the last
        # unit's output (gcn_fpn -1), every unit's (0), the projections
        # fpn_proj{i}[_k{k}] of every unit's output (one, fpn_proj1, for
        # all levels with gcn_fpn_shared), the BiFPN `bifpn` over every
        # unit's output (8), or the last output of the second stack
        # `sgcn2` (10); widths[i] is level i's width (None: no feature)
        last = len(dims) - 1
        self.fpn_mode = gcn_fpn if gcn_fpn in _FPN_WIDTH else None
        self.every_level = gcn_fpn == 0
        self.fpn_projections: List[List[str]] = []
        if self.fpn_mode is not None:
            proj_dim = _FPN_WIDTH[gcn_fpn](dims)
            kernels = ((3,) if gcn_fpn == 7 else (1, 3)
                       if gcn_fpn == 9 and gcn_fpn_kernel == 1
                       else (gcn_fpn_kernel,))
            for k in kernels:
                suffix = f"_k{k}" if gcn_fpn == 9 else ""
                names = [f"fpn_proj{1 if gcn_fpn_shared else i + 1}{suffix}"
                         for i in range(last + 1)]
                for name, c in zip(names, dims):
                    if not hasattr(self, name):
                        self.add_module(name, ConvNormAct(
                            c, proj_dim, k, k // 2, use_bias=use_bias,
                            use_act=False))
                self.fpn_projections.append(names)
            widths = [proj_dim] * (last + 1)
        elif gcn_fpn == 8:
            self.bifpn = BiFPN(dims, bifpn_dim, bifpn_layers)
            widths = [bifpn_dim] * (last + 1)
        elif gcn_fpn == 0:
            widths = list(dims)
        elif gcn_fpn == 10:
            # the units of the second stack read G fixed to the first's
            # last and (attn_mode 10) the injected levels, high to low:
            # the outputs before the last, then the first stack's input
            # (agcn_tpu sgn.py:1013-1042)
            dims2 = tuple(sgcn2_dims or dims)
            self.sgcn2 = GCNSpatialBlock(
                dims[-1], dims2, g_proj, bool(sgcn_g_proj_shared),
                kernel_size=sgcn2_kernel, padding=sgcn2_padding,
                v_kernel=sgcn2_v_kernel, g_activation=sgcn_g_activation,
                gt_mode=0, residual=sgcn2_residual,
                prenorm=bool(sgcn2_prenorm), ffn=sgcn2_ffn,
                dropout=sgcn2_dropout, use_bias=use_bias,
                attn_mode=sgcn2_attn_mode, num_point=v, num_segment=t,
                y_features=([width] + list(dims[:-1]))[::-1])
            widths = [None] * last + [dims2[-1]]
        else:
            widths = [None] * last + [dims[-1]]
        # semantic_joint_smp: a one-hot joint embedding of dims[-1]
        # concatenated on every level's channels before the spatial pool
        # (agcn_tpu sgn.py:1083-1095); its table has no reference buffer
        if semantic_joint_smp > 0:
            self.semantic_embedding["joint_smp_embedding"] = SGNEmbedding(
                v, dims[-1], semantic_joint_smp, use_bias)
            self.semantic_embedding["joint_smp_onehot"] = OneHot(
                v, t, mode=0, persistent=False)
            widths = [c if c is None else c + dims[-1] for c in widths]
        # the spatial pool of each level with a feature: the conv pools'
        # smp{i}_{k,1x1}_{conv,bn} of c3 channels (agcn_tpu
        # sgn.py:1056-1097); the pooled levels concatenated under gcn_fpn
        # 4 and 5; the GT6 maps a level of their own, after both
        self.spatial_maxpool = spatial_maxpool
        self.smp_layers = _POOL_LAYERS.get(spatial_maxpool, ())
        for i, c in enumerate(widths):
            if c is None:
                continue
            for layer in self.smp_layers:
                self.add_module(f"smp{i}_{layer}_conv", _pool_conv(
                    c, c3, (1, v if layer == "k" else 1), use_bias))
                self.add_module(f"smp{i}_{layer}_bn", BatchNorm(c3))
                widths[i] = c = c3
        if gcn_fpn in _FPN_CONCAT:
            widths = [None] * last + [sum(widths)]
        joints = [v if spatial_maxpool == 0 else 1] * len(widths)
        if sgcn_gt_mode == 6:
            widths.append(self.sgcn.g_out_features)
            joints.append(1)
        # multi_t[i] lists level i's kernels; with multi_t_shared 2 one
        # branch a (slot, kernel) pair, named after the first level that
        # declares the pair (agcn_tpu sgn.py:1117-1150); each branch is of
        # `t_mode` with the options of agcn_tpu sgn.py:1134-1146
        shared = {}
        if multi_t_shared == 2:
            for i, kernels in enumerate(multi_t):
                for j, k in enumerate(kernels):
                    shared.setdefault((j, k), f"tem_mlp_{i + 1}_{j + 1}_k{k}")
        self.branches: List[Tuple[int, str]] = []
        for i, kernels in enumerate(multi_t):
            for j, k in enumerate(kernels):
                if i >= len(widths) or widths[i] is None:
                    continue
                name = shared.get((j, k), f"tem_mlp_{i + 1}_{j + 1}_k{k}")
                if not hasattr(self, name):
                    self.add_module(name, TemporalBranch(
                        widths[i], c4, k, dropout2d, use_bias, t_mode,
                        aspp_rates, t_mha_kwargs, t_maxpool_kwargs,
                        decomp_kernel_size, pool_kernel_sizes,
                        num_segment=t, prenorm=bool(sgcn_prenorm),
                        joints=joints[i]))
                elif getattr(self, name).in_features != widths[i]:
                    raise ValueError(
                        f"multi_t_shared: {name} is shared by levels of "
                        f"widths {widths}")
                self.branches.append((i, name))
        if not self.branches:
            raise ValueError(f"multi_t {multi_t!r} gives the levels of "
                             f"widths {widths} no temporal branch")
        # every output (T', V', C'), the GT5 head's among them (agcn_tpu
        # sgn.py:1151-1161), averaged, so equal
        shapes = [getattr(self, name).out_shape for _, name in self.branches
                  for _ in range(len(pool_kernel_sizes) if t_mode == 5
                                 else 3 if t_mode == 4 else 1)]
        if sgcn_gt_mode == 5:
            head = self.sgcn.g_out_features
            if head != shapes[0][-1]:
                raise ValueError(
                    f"gt_mode 5 needs sgcn_gt_out_channels2 == temporal "
                    f"output width ({head} vs {shapes[0][-1]})")
            shapes.append((t, 1, head))
        if len(set(shapes)) > 1:
            raise ValueError(f"t_mode {t_mode}: the temporal outputs are of "
                             f"(T', V', C') {sorted(set(shapes))}, which "
                             "cannot be averaged")
        frames, out_joints, ch = shapes[0]
        # the temporal pool's modules, one set for every branch under
        # gcn_fpn_output_merge 2 (agcn_tpu sgn.py:1171-1193)
        self.temporal_maxpool = temporal_maxpool
        self.tmp_layers = _POOL_LAYERS.get(temporal_maxpool, ())
        if temporal_maxpool == 2:
            self.tmp_ind_projection = ConvNormAct(ch, ch, use_bias=use_bias)
        for layer in self.tmp_layers:
            self.add_module(f"tmp_{layer}_conv", _pool_conv(
                ch, ch, (frames if layer == "k" else 1, 1), use_bias))
            self.add_module(f"tmp_{layer}_bn", BatchNorm(ch))
        width = (frames if temporal_maxpool == 0 else 1) * out_joints * ch
        # the InfoGCN latent head (agcn_tpu sgn.py:1233-1261): the
        # classifier takes z = mu + eps * std in training, mu in eval;
        # z_prior, the MMD loss's class prior, is a fixed buffer
        self.noise_ratio = None
        if infogcn_noise_ratio is not None and infogcn_gain is not None:
            self.noise_ratio = float(infogcn_noise_ratio)
            self.fc_mu = nn.utils.skip_init(nn.Linear, width, width)
            self.fc_logvar = nn.utils.skip_init(nn.Linear, width, width)
            self.register_buffer("z_prior", torch.empty(num_class, width))
            self.prior_gain = float(infogcn_gain)
        self.fc_drop = Dropout(dropout)
        # gcn_fpn_output_merge 2: a head fc{i} an output, the logits
        # averaged (agcn_tpu sgn.py:1264-1276); else one `fc`
        self.merge2 = gcn_fpn_output_merge == 2
        self.heads = ([f"fc{i + 1}" for i in range(len(shapes))]
                      if self.merge2 else ["fc"])
        for name in self.heads:
            self.add_module(name, nn.utils.skip_init(nn.Linear, width,
                                                     num_class))

        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.reset_parameters(generator)
        self.to(device)
        self.dropout_generator = None
        # the temporal encoder's dropout defaults to 0.1 (agcn_tpu
        # sgn.py:721)
        mha_dropout = t_mode == 3 and (t_mha_kwargs or {}).get("dropout",
                                                               0.1)
        if (dropout or dropout2d or sgcn_dropout or mha_dropout
                or self.noise_ratio is not None or sgcn_gt_mode == 5
                or (gcn_fpn == 10 and sgcn2_dropout)):
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)
            for mod in self.modules():
                if isinstance(mod, Dropout):
                    mod.generator = self.dropout_generator

    def reset_parameters(self, generator: torch.Generator) -> None:
        for emb in self.feature_extractor.values():
            emb.reset_parameters(generator)
        for emb in self.semantic_embedding.values():
            if isinstance(emb, SGNEmbedding):
                emb.reset_parameters(generator)
        if hasattr(self, "x_emb_projection"):
            self.x_emb_projection.reset_parameters(generator)
        self.sgcn.reset_parameters(generator)
        for name in ("sgcn2", "bifpn"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)
        for name in dict.fromkeys(n for names in self.fpn_projections
                                  for n in names):
            getattr(self, name).reset_parameters(generator)
        for name in dict.fromkeys(name for _, name in self.branches):
            getattr(self, name).reset_parameters(generator)
        for name, mod in self.named_children():
            if isinstance(mod, nn.Conv2d):  # the conv pools (bias 0)
                init.kaiming_normal_fan_out(mod.weight, generator)
                if mod.bias is not None:
                    with torch.no_grad():
                        mod.bias.zero_()
        if hasattr(self, "tmp_ind_projection"):
            self.tmp_ind_projection.reset_parameters(generator)
        if self.noise_ratio is not None:
            for fc in (self.fc_mu, self.fc_logvar):
                init.torch_default(fc.in_features)(fc.weight, generator)
                init.torch_default(fc.in_features)(fc.bias, generator)
            with torch.no_grad():
                nn.init.orthogonal_(self.z_prior, gain=self.prior_gain,
                                    generator=generator)
        for name in self.heads:
            fc = getattr(self, name)
            init.torch_default(fc.in_features)(fc.weight, generator)
            init.torch_default(fc.in_features)(fc.bias, generator)

    def _levels(self, feat: torch.Tensor,
                g_list: List[Tuple[torch.Tensor, Any]],
                x_list: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """The GCN-FPN's features, one a level (None: no feature)."""
        if hasattr(self, "bifpn"):
            return self.bifpn(list(x_list))
        if hasattr(self, "sgcn2"):
            inject = ([feat] + list(x_list[:-1]))[::-1]
            _, _, x2 = self.sgcn2(x_list[-1], inject, g_list[-1][0])
            return [None] * (len(x_list) - 1) + [x2[-1]]
        if self.fpn_mode is None:
            return (list(x_list) if self.every_level
                    else [None] * (len(x_list) - 1) + [x_list[-1]])
        proj = None
        for names in self.fpn_projections:
            p = [getattr(self, n)(xl) for n, xl in zip(names, x_list)]
            proj = p if proj is None else [a + b for a, b in zip(proj, p)]
        if self.fpn_mode in _FPN_SUM:
            return [sum(proj[i:]) for i in range(len(proj))]
        return proj

    def _conv_pool(self, prefix: str, layers: Sequence[str],
                   x: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            y = getattr(self, f"{prefix}_{layer}_conv")(
                x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = torch.relu(getattr(self, f"{prefix}_{layer}_bn")(y))
        return x

    def _spatial_pool(self, i: int, f: torch.Tensor) -> torch.Tensor:
        if self.spatial_maxpool == 0:
            return f
        if self.spatial_maxpool == 1:
            return torch.amax(f, dim=2, keepdim=True)
        return self._conv_pool(f"smp{i}", self.smp_layers, f)

    def _temporal_pool(self, y: torch.Tensor) -> torch.Tensor:
        if self.temporal_maxpool == 0:
            return y
        if self.temporal_maxpool == 1:
            return torch.amax(y, dim=1, keepdim=True)
        if self.temporal_maxpool == 2:
            # the max plus the projection of its frame (the first of a
            # tie, in both frameworks; agcn_tpu sgn.py:1199-1205)
            idx = torch.argmax(y, dim=1, keepdim=True).to(y.dtype)
            return (torch.amax(y, dim=1, keepdim=True)
                    + self.tmp_ind_projection(idx))
        return self._conv_pool("tmp", self.tmp_layers, y)

    def forward(self, x: torch.Tensor, return_g: bool = False,
                return_aux: bool = False):
        b, t, dim = x.shape
        v = self.num_point
        if t != self.num_segment:
            raise ValueError(
                f"SGN built for {self.num_segment} segments (the one-hot "
                f"frame table) got an input of {t}; build it with "
                f"num_segment={t}")
        x = x.reshape(b, t, v, dim // v)[..., :self.in_channels]
        # velocity: the difference padded with a leading zero frame
        # (blocks/feature_extractor.py:75-79); the segment embeddings
        # embed x in both streams, as the reference does
        dif = (x if self.segments else torch.cat(
            [torch.zeros_like(x[:, :1]), x[:, 1:] - x[:, :-1]], dim=1))
        fe, se = self.feature_extractor, self.semantic_embedding
        streams = [fe[name](inp) for name, inp in (("pos_embed", x),
                                                   ("vel_embed", dif))
                   if name in fe]

        def joint_table(name: str, table: str) -> torch.Tensor:
            return se[name](se[table].table()).expand(b, -1, -1, -1)

        def fuse(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
            return torch.cat([a, e], dim=-1) if self.fusion == 0 else a + e

        if self.jdiff:
            feat = (fuse(streams[0], joint_table("spa_embedding",
                                                 "spa_onehot"))
                    + fuse(streams[1], joint_table("jdiff_embedding",
                                                   "spa_onehot")))
        else:
            feat = (streams[0] if len(streams) == 1
                    else streams[0] + streams[1])
            if "spa_embedding" in se:
                feat = fuse(feat, joint_table("spa_embedding",
                                              "spa_onehot"))
        if hasattr(self, "x_emb_projection"):
            feat = self.x_emb_projection(feat)
        # the frame embedding before the GCN stack, as JAX orders its calls
        tem = (se["tem_embedding"](se["tem_onehot"].table())
               if "tem_embedding" in se else None)
        if tem is not None and self.frame_first:
            feat, tem = feat + tem, None
        _, g_list, x_list = self.sgcn(feat)
        smp = (joint_table("joint_smp_embedding", "joint_smp_onehot")
               if "joint_smp_embedding" in se else None)
        pooled = []
        for i, f in enumerate(self._levels(feat, g_list, x_list)):
            if f is not None:
                if tem is not None and f.shape[-1] == tem.shape[-1]:
                    f = f + tem
                if smp is not None:
                    f = torch.cat([f, smp], dim=-1)
                f = self._spatial_pool(i, f)
            pooled.append(f)
        if self.fpn_mode in _FPN_CONCAT:
            pooled = [None] * (len(pooled) - 1) + [torch.cat(pooled, -1)]
        if self.gt_mode == 6:  # the maps' level (agcn_tpu sgn.py:1106-1111)
            pooled.append(g_list[0][1])
        # level, then branch slot, then the mode's outputs (agcn_tpu
        # sgn.py:1113-1150), then GT5's head
        outs = [o for i, name in self.branches
                for o in getattr(self, name)(pooled[i])]
        if self.gt_mode == 5:
            outs.append(g_list[0][1])
        ys = outs if self.merge2 else [
            outs[0] if len(outs) == 1 else torch.stack(outs).mean(dim=0)]
        ys = [self._temporal_pool(y) for y in ys]
        if "cls_embedding" in se:
            cls = se["cls_embedding"](se["cls_onehot"].table())
            ys = [y + cls for y in ys]
        zs = [y.reshape(b, -1) for y in ys]
        z = zs[0]
        if self.noise_ratio is not None:
            mu = self.fc_mu(z)
            if self.training:
                logvar = self.fc_logvar(z)
                eps = latent_noise(logvar.shape, self.dropout_generator,
                                   logvar.device)
                std = torch.clamp(torch.exp(self.noise_ratio * logvar),
                                  max=100.0)
                z = eps * std + mu
            else:
                z = mu
            zs = [z]
        logits = [getattr(self, name)(self.fc_drop(zi))
                  for name, zi in zip(self.heads, zs)]
        logits = (logits[0] if len(logits) == 1
                  else torch.stack(logits).mean(dim=0))
        g_maps = [g for g, _ in g_list]
        if return_aux:
            # each output (B, T', V', C) as (N, V' C, T'): the reference's
            # CosineLoss takes dim 1 as the channels
            branch_outputs = [o.reshape(b, o.shape[1], -1).transpose(1, 2)
                              for o in outs]
            aux = {"g": g_maps, "branch_outputs": branch_outputs, "z": z}
            if self.noise_ratio is not None:
                aux["z_prior"] = self.z_prior
            return logits, aux
        return (logits, g_maps) if return_g else logits
