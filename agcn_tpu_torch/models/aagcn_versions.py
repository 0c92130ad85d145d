"""The version-faithful AAGCN transformer variants (port of
agcn_tpu/models/aagcn_versions.py): v17, v24, v30, v31 (and v32, as v31
with `version='v32'`) and v34, each the reference experiment's math with
its quirks, so that its weights load by the reference torch names.

- `AAGCNv17` (:150-222): an AAGCN backbone whose every unit strides by
  the kernel size ("patchify"), then a temporal transformer over (N,
  M*T' (+CLS), V*C) tokens; learned or cos-sin positions (base 100);
  optional causal / anti-causal additive masks on the last layer only.
- `AAGCNv24` (:224-334): a per-frame spatial transformer over (N*T',
  M*V + CLS, C) tokens, block-diagonal PA masks scaled by a shared alpha
  and added to the logits, and the bug-compatible CLS_MASK readout.
- `AAGCNv31` (:336-555; v32 with `version='v32'`): spatial (joint
  tokens, T'*C wide) and temporal (frame tokens, V*C wide) layers
  interleaved by `trans_seq`, per-subset spatial layers with PA masks,
  and v32's per-layer alphas, post-softmax injection ('attn-a') and
  bias-less layers.
- `AAGCNv30` (:882-958): a GCN unit (`GCNUnitLocal` over
  `AdaptiveGCNv2` or the per-frame `AdaptiveGCNv3`) as the spatial
  layer, a transformer layer as the temporal one.
- `AAGCNv34` (:558-784): per-person temporal / spatial interleave, with
  torch's MHA (its biases lost to the reference's positional-argument
  slip) or the forked MHA with a shared relative position bias ('-v2',
  '-v3').

v29, v33, v35, v36 and v37 are broken as shipped in the reference, and
neither package builds them (the registry raises KeyError).

The backbone (data norm, then `TCNGCNUnit`s of `layer_plan` at the
AAGCN's default forms: 'agg_packed' in train, 'agg' at eval) runs in
`dtype`; its features are cast to fp32 for the transformer layers, as in
the AAGCN transformer (the JAX versions take no dtype: the backbone in
bf16 is the port's). The versions launch none of the port's kernels, as
the JAX versions reach no Pallas kernel.

v31 and v34 size their spatial tokens (T' * C wide) from the input's
frames: `num_frame` names them (the trainer passes its data's T, the
server `--max-frame`), and another input length, or weights made for
another T, raise with both Ts. Every version takes the reference
`Model`'s parameter names (`cls_token`, `t_pos_encoder.pe`,
`t_trans_enc_layers.N`, `s_trans_enc_layers.N.subsetK.PA`, ...), which
`utils/weights.aagcn_v*_state_dict_from_variables` write. Every dropout
draws from one generator on the model's device, seeded from `generator`
(`dropout_seed`; the train step reseeds it for each update).
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from agcn_tpu_torch.models.aagcn import TCNGCNUnit, layer_plan
from agcn_tpu_torch.ops import BatchNorm, LayerNorm, PointwiseConv
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import sync_batch_norms
from agcn_tpu_torch.ops.attention import (Dropout, TransformerEncoderLayer,
                                          layer_norm)
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _cossin_table(d_model: int, max_len: int, base: float) -> np.ndarray:
    """The reference CosSinPositionalEncoding table (1, max_len, d_model);
    v17 uses base 100 (agcn_tpu aagcn_versions.py:63-71)."""
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(base) / d_model))
    pe = np.zeros((1, max_len, d_model), np.float32)
    pe[0, :, 0::2] = np.sin(position * div)
    pe[0, :, 1::2] = np.cos(position * div)
    return pe


def _pos_kind(pos_enc) -> str:
    """A recipe's `pos_enc` -> 'learned', 'cossin' or 'none'."""
    if pos_enc in ("True", "original"):
        return "learned"
    return "cossin" if pos_enc == "cossin" else "none"


class PosEncoding(nn.Module):
    """Learned positions `pe` (1, max_len, D), normal(0.02), or the fixed
    cos-sin table, or none; adds the first L rows to L tokens."""

    def __init__(self, kind: str, d_model: int, max_len: int = 601,
                 base: float = 10000.0):
        super().__init__()
        self.kind = kind
        if kind == "learned":
            self.pe = nn.Parameter(torch.empty(1, max_len, d_model))
        elif kind == "cossin":
            self.register_buffer(
                "pe", torch.from_numpy(_cossin_table(d_model, max_len, base)),
                persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.kind == "learned":
            init.normal(0.02)(self.pe, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        return x + self.pe[:, :x.shape[1]]


def _subsequent_additive_mask(sz: int, backward: bool) -> torch.Tensor:
    """torch's generate_square_subsequent_mask (transposed for
    'backward'), with -1e9 where torch has -inf (aagcn_versions.py:95-101)."""
    allow = np.tril(np.ones((sz, sz), bool))
    if backward:
        allow = allow.T
    return torch.from_numpy(np.where(allow, 0.0, -1e9).astype(np.float32))


class SubsetLayer(TransformerEncoderLayer):
    """A transformer layer that carries the attention prior of its
    spatial step: `PA` (initialized from the graph) and, where the version
    has one, its own `alpha` (the reference registers both on the
    layer)."""

    def __init__(self, *args, pa: np.ndarray,
                 alpha: Optional[float] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.pa_init = np.asarray(pa, np.float32)
        self.alpha_init = alpha
        self.PA = nn.Parameter(torch.from_numpy(self.pa_init.copy()))
        self.alpha = (nn.Parameter(torch.full((1,), float(alpha)))
                      if alpha is not None else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.PA.copy_(torch.from_numpy(self.pa_init))
            if self.alpha is not None:
                self.alpha.fill_(float(self.alpha_init))


class _Version(nn.Module):
    """What the versions share: the data norm and the patchify backbone
    (`_preprocess`, `_backbone`, aagcn_versions.py:104-136), and the
    `drop_out` + `fc` head (`_classify`, :139-147)."""

    takes_num_frame = True  # build_model passes the input's frames

    def _build_backbone(self, num_class: int, num_point: int,
                        num_person: int, in_channels: int, adj, adaptive,
                        attention, kernel_size: int, pad: bool,
                        model_layers: int, output_channel: int,
                        data_norm: str, drop_out: float, dtype,
                        num_frame: int, sync_axis) -> None:
        if adj is None:
            raise ValueError("adj: the (K, V, V) adjacency stack is required")
        self.adj = np.asarray(adj, np.float32)
        self.num_class = num_class
        self.num_point = num_point
        self.num_person = num_person
        self.dtype = dtype
        self.data_norm = data_norm
        if data_norm == "bn":
            self.data_bn = BatchNorm(num_person * num_point * in_channels)
        elif data_norm == "ln":
            self.data_bn = LayerNorm(num_point * in_channels)
        else:
            raise ValueError(f"unknown data_norm {data_norm!r}")
        plan = layer_plan(model_layers, output_channel)
        self.block_names = []
        c, t = in_channels, num_frame
        for name in [f"l{i}" for i in range(1, 11)]:
            if name not in plan:
                continue
            ch, _, residual, _ = plan[name]
            # every unit strides by the kernel size, whatever the plan's
            # stride and pad (aagcn_versions.py:122-136)
            block = TCNGCNUnit(c, ch, self.adj, stride=kernel_size,
                               residual=residual, kernel_size=kernel_size,
                               pad=pad, dtype=dtype, adaptive=adaptive,
                               attention=attention)
            self.add_module(name, block)
            self.block_names.append(name)
            conv = block.tcn1.conv
            t = (t + 2 * conv.pad - kernel_size) // kernel_size + 1
            c = ch
        self.channels = c
        self.num_frame = num_frame
        self.backbone_frames = t
        self.fc_drop = Dropout(drop_out)
        # SyncBN on the data norm and the backbone's units, as JAX's
        # _preprocess and _backbone pass sync_axis (:104-136)
        self.sync_axis = sync_axis
        if sync_axis is not None:
            for name in ["data_bn"] + self.block_names:
                sync_batch_norms(getattr(self, name), sync_axis)

    def _head(self, width: int) -> None:
        self.fc = nn.utils.skip_init(nn.Linear, width, self.num_class)

    def _finish(self, device, generator: Optional[torch.Generator]) -> None:
        """Initialize from `generator` (seed 0 when None), move to
        `device`, and give every dropout one generator there."""
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        for name in self.block_names:
            getattr(self, name).reset_parameters(generator)
        self.reset_parameters(generator)
        init.fc_init(self.num_class)(self.fc.weight, generator)
        with torch.no_grad():
            self.fc.bias.zero_()
        self.to(device)
        self.dropout_generator = None
        drops = [m for m in self.modules() if isinstance(m, Dropout)]
        if any(m.p > 0 for m in drops):
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)
            for m in drops:
                m.generator = self.dropout_generator

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The version's own parameters (the blocks and fc are done)."""
        for m in self.modules():
            if m is not self and isinstance(
                    m, (TransformerEncoderLayer, PosEncoding)):
                m.reset_parameters(generator)

    def _features(self, x: torch.Tensor):
        """Data norm, persons into the batch, the backbone; the (N*M, T',
        V, C) features in fp32 and (n, m)."""
        n, c, t, v, m = x.shape
        if self.data_norm == "bn":
            y = x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * c)
            y = self.data_bn(y).reshape(n, t, m, v, c)
            y = y.permute(0, 2, 1, 3, 4).reshape(n * m, t, v, c)
        else:
            y = x.permute(0, 4, 2, 3, 1).reshape(n * m, t, v * c)
            y = self.data_bn(y).reshape(n * m, t, v, c)
        if self.dtype is not None:
            y = y.to(self.dtype)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return y.float(), n, m

    def _classify(self, feat: torch.Tensor) -> torch.Tensor:
        return self.fc(self.fc_drop(feat))


def _readout(tokens: torch.Tensor, classifier_type: str) -> torch.Tensor:
    if classifier_type == "CLS":
        return tokens[:, 0]
    return tokens.mean(dim=1)  # 'GAP'


def _check_classifier(classifier_type: str, allowed) -> None:
    if classifier_type not in allowed:
        raise ValueError("Unknown classifier_type")


class AAGCNv17(_Version):
    """Reference aagcn_v17.py Model: patchify backbone, then a temporal
    transformer encoder with optional causal / anti-causal masking of its
    last layer (aagcn_versions.py:150-222)."""

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3, adj=None,
                 adaptive: bool = True, attention: bool = True,
                 data_norm: str = "bn", kernel_size: int = 9,
                 pad: bool = True, attn_masking: str = "False",
                 trans_num_heads: int = 2, trans_model_dim: int = 16,
                 trans_ffn_dim: int = 64, trans_dropout: float = 0.2,
                 trans_activation: str = "gelu",
                 trans_prenorm: bool = False, trans_num_layers: int = 1,
                 pos_enc: str = "True", classifier_type: str = "CLS",
                 drop_out: float = 0.0, model_layers: int = 10,
                 sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_classifier(classifier_type, ("CLS", "GAP"))
        self._build_backbone(num_class, num_point, num_person, in_channels,
                             adj, adaptive, attention, kernel_size, pad,
                             model_layers, trans_model_dim, data_norm,
                             drop_out, dtype, num_frame, sync_axis)
        self.classifier_type = classifier_type
        self.attn_masking = attn_masking
        width = num_point * self.channels
        if classifier_type == "CLS":
            self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_encoder = PosEncoding(_pos_kind(pos_enc), width, base=100.0)
        self.trans_enc = nn.ModuleList(
            TransformerEncoderLayer(width, trans_num_heads,
                                    trans_ffn_dim * num_point, trans_dropout,
                                    trans_activation, trans_prenorm)
            for _ in range(trans_num_layers))
        self._head(width)
        self._finish(device, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.classifier_type == "CLS":
            init.normal(1.0)(self.cls_token, generator)
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        y, n, m = self._features(x)
        _, t2, v2, ch = y.shape
        tokens = y.reshape(n, m * t2, v2 * ch)
        if self.classifier_type == "CLS":
            tokens = torch.cat([self.cls_token.expand(n, 1, -1), tokens], 1)
        tokens = self.pos_encoder(tokens)
        mask = None
        if self.attn_masking in ("forward", "backward"):
            mask = _subsequent_additive_mask(
                tokens.shape[1], self.attn_masking == "backward").to(
                    tokens.device)
        attn = []
        for i, layer in enumerate(self.trans_enc):
            last = i == len(self.trans_enc) - 1
            tokens, a = layer(tokens, additive_mask=mask if last else None)
            attn.append(a)
        logits = self._classify(_readout(tokens, self.classifier_type))
        return (logits, attn) if return_attention else logits


class AAGCNv24(_Version):
    """Reference aagcn_v24.py Model: a per-frame spatial transformer over
    (N*T', M*V + CLS, C) tokens (aagcn_versions.py:224-334).

    `add_A` 'single' adds a (M*V+1)^2 mask, block-diagonal from A[0] over
    the two persons' joints and ones elsewhere, 'triple' a (K, L, L) one
    per head (needs K heads), each layer's `PA` times the shared `alpha`.
    'CLS' mean-pools the frames' CLS tokens; 'CLS_MASK' reproduces the
    reference's masked mean with its inverted mask: only the CLS tokens
    of all-zero frames count (aagcn_v24.py:311-320)."""

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3, adj=None,
                 adaptive: bool = True, attention: bool = True,
                 kernel_size: int = 9, pad: bool = True,
                 add_A: str = "False", s_num_heads: int = 3,
                 s_model_dim: int = 24, s_ffn_dim: int = 96,
                 dropout: float = 0.0, activation: str = "gelu",
                 prenorm: bool = False, num_layers: int = 3,
                 pos_enc: str = "True", classifier_type: str = "CLS",
                 drop_out: float = 0.0, model_layers: int = 101,
                 sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_classifier(classifier_type, ("CLS", "CLS_MASK"))
        self._build_backbone(num_class, num_point, num_person, in_channels,
                             adj, adaptive, attention, kernel_size, pad,
                             model_layers, s_model_dim, "bn", drop_out,
                             dtype, num_frame, sync_axis)
        self.kernel_size = kernel_size
        self.classifier_type = classifier_type
        self.add_A = add_A
        ch = self.channels
        self.s_cls_token = nn.Parameter(torch.empty(1, 1, ch))
        self.s_pos_encoder = PosEncoding(_pos_kind(pos_enc), ch, max_len=100)
        self.alpha = nn.Parameter(torch.zeros(1))
        layer = dict(dim=ch, num_heads=s_num_heads,
                     dim_feedforward=s_ffn_dim, dropout=dropout,
                     activation=activation, pre_norm=prenorm)
        if add_A in ("single", "triple"):
            v, tok = num_point, num_person * num_point + 1
            k = self.adj.shape[0]
            if add_A == "triple":
                base = np.ones((k, tok, tok), np.float32)
                base[:, 1:v + 1, 1:v + 1] = self.adj
                base[:, v + 1:, v + 1:] = self.adj
            else:
                base = np.ones((tok, tok), np.float32)
                base[1:v + 1, 1:v + 1] = self.adj[0]
                base[v + 1:, v + 1:] = self.adj[0]
            self.s_trans_enc_layers = nn.ModuleList(
                SubsetLayer(pa=base, **layer) for _ in range(num_layers))
        else:
            self.s_trans_enc_layers = nn.ModuleList(
                TransformerEncoderLayer(**layer) for _ in range(num_layers))
        self._head(ch)
        self._finish(device, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.normal(1.0)(self.s_cls_token, generator)
        with torch.no_grad():
            self.alpha.zero_()
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        if self.classifier_type == "CLS_MASK":
            # the empty-frame indicator, windowed by the patchify stride
            empty = (x.sum(dim=(1, 3, 4)) == 0.0).float()
            empty = empty[:, ::self.kernel_size]  # (N, T')
        y, n, m = self._features(x)
        _, t2, v2, ch = y.shape
        z = y.reshape(n, m, t2, v2, ch).permute(0, 2, 1, 3, 4).reshape(
            n * t2, m * v2, ch)
        tokens = torch.cat([self.s_cls_token.expand(n * t2, 1, -1), z], 1)
        tokens = self.s_pos_encoder(tokens)
        attn = []
        for layer in self.s_trans_enc_layers:
            mask = None
            if self.add_A in ("single", "triple"):
                mask = layer.PA * self.alpha
                if self.add_A == "triple":
                    mask = mask[None]  # (1, H = K, L, L)
            tokens, a = layer(tokens, additive_mask=mask)
            attn.append(a)
        frame_cls = tokens[:, 0].reshape(n, t2, ch)
        if self.classifier_type == "CLS":
            feat = frame_cls.mean(dim=1)
        else:
            # bug-compatible: times the EMPTY-frame indicator, mean over
            # all frames (aagcn_v24.py:317-318)
            feat = (frame_cls * empty[:, :, None]).mean(dim=1)
        logits = self._classify(feat)
        return (logits, attn) if return_attention else logits


def _check_frames(model: _Version, t2: int, x: torch.Tensor) -> None:
    if t2 != model.backbone_frames:
        raise ValueError(
            f"an input of T = {x.shape[2]} frames gives T' = {t2} after the "
            f"backbone; this model's spatial tokens are sized for T' = "
            f"{model.backbone_frames} (num_frame={model.num_frame}). Build "
            "the model for the input's T.")


class _SpatialWidth:
    """v31 / v34: their spatial layers' width is T' * C, so weights made
    for another T cannot load; say so with both Ts."""

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        own = self.state_dict()
        for key, got in state_dict.items():
            if key.startswith("s_trans_enc_layers.") and key.endswith(
                    "self_attn.in_proj_weight") and key in own \
                    and got.shape[1] != own[key].shape[1]:
                raise ValueError(
                    f"{key}: the weights' spatial tokens are "
                    f"{got.shape[1]} wide, T' = "
                    f"{got.shape[1] // self.channels} frames after the "
                    f"backbone; this model's are {own[key].shape[1]}, for "
                    f"T' = {self.backbone_frames} (num_frame="
                    f"{self.num_frame}). Build the model for the weights' T.")
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


V31_SEQS = ("s-t", "sa-t", "sa-t-res", "t-s", "sa-t-attn-a",
            "sa-t-res-attn-a")


class AAGCNv31(_SpatialWidth, _Version):
    """Reference aagcn_v31.py / aagcn_v32.py Models: spatial and temporal
    transformer layers interleaved over patchified AAGCN features
    (aagcn_versions.py:336-555).

    Spatial tokens are joints, T' * C wide; temporal tokens are frames,
    V * C wide, with a CLS slot. `trans_seq` orders the two in a layer:
    's-t' (one spatial layer over (N, M*V, T'*C), then temporal), 'sa-t'
    (per-subset spatial layers over (N*M, V, T'*C) whose outputs add onto
    x, then the shared `sa_norm`), 'sa-t-res' (as 'sa-t' with dropout,
    and a residual, dropout and `res_norm` around the temporal layer),
    't-s'. With `add_A` each subset layer's mask is its `PA` (from the
    graph) times the shared `alpha` (`add_Aa`) or 1; `version='v32'`
    gives each subset layer its own alpha: 'sa-t' adds PA * alpha to the
    logits, 'sa-t-res' injects it after the softmax, and 'sa-t-attn-a' /
    'sa-t-res-attn-a' apply softmax * alpha + PA. v32's layers have no
    biases (aagcn_v32.py:77-78)."""

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3, adj=None,
                 adaptive: bool = True, attention: bool = True,
                 kernel_size: int = 9, pad: bool = True,
                 backbone_dim: int = 16, add_A: bool = False,
                 add_Aa: bool = False, version: str = "v31",
                 trans_seq: str = "s-t", multi_trans_dropout: float = 0.0,
                 res_dropout: float = 0.2, t_num_heads: int = 2,
                 t_model_dim: int = 16, t_ffn_dim: int = 64,
                 s_num_heads: int = 2, s_model_dim: int = 16,
                 s_ffn_dim: int = 64, dropout: float = 0.0,
                 activation: str = "gelu", prenorm: bool = False,
                 num_layers: int = 3, pos_enc: str = "True",
                 classifier_type: str = "CLS", drop_out: float = 0.0,
                 model_layers: int = 101, sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_classifier(classifier_type, ("CLS", "GAP"))
        if trans_seq not in V31_SEQS:
            raise ValueError(f"unknown trans_seq {trans_seq!r}")
        self._build_backbone(num_class, num_point, num_person, in_channels,
                             adj, adaptive, attention, kernel_size, pad,
                             model_layers, backbone_dim, "bn", drop_out,
                             dtype, num_frame, sync_axis)
        self.version = version
        self.trans_seq = trans_seq
        self.add_A = add_A
        self.classifier_type = classifier_type
        ch, t2 = self.channels, self.backbone_frames
        t_dim, s_dim = num_point * ch, t2 * ch
        if classifier_type == "CLS":
            self.cls_token = nn.Parameter(torch.empty(1, 1, t_dim))
        self.t_pos_encoder = PosEncoding(_pos_kind(pos_enc), t_dim)
        self.alpha = (nn.Parameter(torch.zeros(1)) if add_A and add_Aa
                      else None)
        bias = version != "v32"  # v32's positional-argument slip
        common = dict(dropout=dropout, activation=activation,
                      pre_norm=prenorm, bias=bias)
        self.t_trans_enc_layers = nn.ModuleList(
            TransformerEncoderLayer(t_dim, t_num_heads,
                                    t_ffn_dim * num_point, **common)
            for _ in range(num_layers))
        s_layer = dict(dim=s_dim, num_heads=s_num_heads,
                       dim_feedforward=s_ffn_dim * t2, **common)
        layers = []
        for _ in range(num_layers):
            if add_A and trans_seq.startswith("sa"):
                layers.append(nn.ModuleDict({
                    f"subset{a}": SubsetLayer(
                        pa=self.adj[a],
                        alpha=0.0 if version == "v32" else None, **s_layer)
                    for a in range(self.adj.shape[0])}))
            else:
                layers.append(TransformerEncoderLayer(**s_layer))
        self.s_trans_enc_layers = nn.ModuleList(layers)
        # one shared sa_norm with add_A, res_norm for the '-res' sequences
        self.sa_norm = layer_norm(s_dim) if add_A else None
        self.res_norm = layer_norm(t_dim) if "res" in trans_seq else None
        self.mt_drop = Dropout(multi_trans_dropout)
        self.res_drop = Dropout(res_dropout)
        self._head(t_dim)
        self._finish(device, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.classifier_type == "CLS":
            init.normal(1.0)(self.cls_token, generator)
        if self.alpha is not None:
            with torch.no_grad():
                self.alpha.zero_()
        super().reset_parameters(generator)

    def _subset_args(self, layer: SubsetLayer):
        """(additive_mask, alpha, global_attn) of a subset layer."""
        pa = layer.PA
        if self.version != "v32":
            return pa * (self.alpha if self.alpha is not None else 1.0), \
                None, None
        if self.trans_seq == "sa-t":
            return pa * layer.alpha, None, None
        if self.trans_seq == "sa-t-res":
            return None, None, pa * layer.alpha
        return None, layer.alpha, pa  # the 'attn-a' modes

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        y, n, m = self._features(x)
        _, t2, v2, ch = y.shape
        _check_frames(self, t2, x)
        t_dim, s_dim = v2 * ch, t2 * ch
        has_cls = self.classifier_type == "CLS"
        tokens = y.reshape(n, m * t2, t_dim)
        if has_cls:
            tokens = torch.cat([self.cls_token.expand(n, 1, -1), tokens], 1)
        tokens = self.t_pos_encoder(tokens)

        def to_joints(body):  # (N, M*T', V*C) -> (N, M, V, T', C)
            return body.reshape(n, m, t2, v2, ch).permute(0, 1, 3, 2, 4)

        def to_body(z):  # (N, M, V, T', C) -> (N, M*T', V*C)
            return z.permute(0, 1, 3, 2, 4).reshape(n, m * t2, t_dim)

        def strip(tok):
            return tok[:, 1:] if has_cls else tok

        def attach(body, tok):
            return torch.cat([tok[:, :1], body], 1) if has_cls else body

        def spatial_plain(tok, i):
            z = to_joints(strip(tok)).reshape(n, m * v2, s_dim)
            z, _ = self.s_trans_enc_layers[i](z)
            return attach(to_body(z.reshape(n, m, v2, t2, ch)), tok)

        def spatial_attn(tok, i):
            """(the (N*M, V, T'*C) joint tokens, the spatial outputs'
            sum)."""
            z = to_joints(strip(tok)).reshape(n * m, v2, s_dim)
            layers = self.s_trans_enc_layers[i]
            if not self.add_A:
                return z, layers(z)[0]
            total = 0
            for layer in layers.values():
                mask, alpha, g_attn = self._subset_args(layer)
                total = total + layer(z, additive_mask=mask, alpha=alpha,
                                      global_attn=g_attn)[0]
            return z, total

        def reattach(z, tok):
            return attach(to_body(z.reshape(n, m, v2, t2, ch)), tok)

        seq = self.trans_seq
        for i in range(len(self.t_trans_enc_layers)):
            t_layer = self.t_trans_enc_layers[i]
            if seq == "s-t":
                tokens = t_layer(spatial_plain(tokens, i))[0]
            elif seq in ("sa-t", "sa-t-attn-a"):
                z, s_sum = spatial_attn(tokens, i)
                z = z + s_sum
                if self.sa_norm is not None:
                    z = self.sa_norm(z)
                tokens = t_layer(reattach(z, tokens))[0]
            elif seq in ("sa-t-res", "sa-t-res-attn-a"):
                z, s_sum = spatial_attn(tokens, i)
                z = z + self.mt_drop(s_sum)
                if self.sa_norm is not None:
                    z = self.sa_norm(z)
                x2 = t_layer(reattach(z, tokens))[0]
                tokens = self.res_norm(tokens + self.res_drop(x2))
            else:  # 't-s'
                tokens = spatial_plain(t_layer(tokens)[0], i)
        logits = self._classify(_readout(tokens, self.classifier_type))
        return (logits, []) if return_attention else logits


class AAGCNv34(_SpatialWidth, _Version):
    """Reference aagcn_v34.py Model: per-PERSON temporal / spatial
    transformer interleave over (N*M, T' (+CLS), V*C) tokens
    (aagcn_versions.py:558-784).

    's-t' / 't-s' use plain layers: torch's MHA, which the reference's
    positional-argument slip leaves without biases, as it does every
    linear and LayerNorm of every layer. 'sa-t[-res]' runs per-subset
    spatial layers whose PA (times its alpha, `add_Aa`) the forked MHA
    injects after the softmax; with torch's MHA (no '-v2' / '-v3') the
    reference drops them silently, and so does this. '-v2' / '-v3' take
    the forked MHA, with biases, and with `pos_emb` 'rel...' a relative
    position bias of `t_length` / `s_length` (the sequence must be that
    long: the rel modes need the CLS slot). '-v3' replaces the spatial
    tokens with the dropped subset sum under the layer's own `sa_norm`
    and applies softmax * alpha + PA. '-res' wraps the temporal output in
    dropout, a residual and `res_norm`. The readout is token 0 of the
    (N, M*(T'+1), V*C) tokens: person 0's CLS; 'CLS-POOL' adds fc + tanh.
    """

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3, adj=None,
                 adaptive: bool = True, attention: bool = True,
                 kernel_size: int = 9, pad: bool = True,
                 backbone_dim: int = 16, trans_len: int = 100,
                 add_A: bool = False, add_Aa: str = "None",
                 trans_seq: str = "s-t", multi_trans_dropout: float = 0.0,
                 res_dropout: float = 0.2, t_num_heads: int = 2,
                 t_model_dim: int = 16, t_ffn_dim: int = 64,
                 t_length: int = 101, s_num_heads: int = 2,
                 s_model_dim: int = 16, s_ffn_dim: int = 64,
                 s_length: int = 25, pos_emb: str = "rel-shared",
                 dropout: float = 0.0, activation: str = "gelu",
                 prenorm: bool = False, num_layers: int = 3,
                 pos_enc: str = "True", classifier_type: str = "CLS",
                 drop_out: float = 0.0, model_layers: int = 101,
                 sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_classifier(classifier_type, ("CLS", "CLS-POOL", "GAP"))
        seq = trans_seq.replace("-v2", "").replace("-v3", "")
        fork = "v2" in trans_seq or "v3" in trans_seq
        # plain 's-t-res' is not dispatched by the reference
        # (aagcn_v34.py:452-503) and would NameError there
        if seq not in ("s-t", "t-s", "sa-t", "sa-t-res") and not (
                seq == "s-t-res" and fork):
            raise ValueError(f"unknown trans_seq {trans_seq!r}")
        if "v3" in trans_seq and seq.startswith("sa") and not add_A:
            raise ValueError("trans_seq 'sa-t*-v3' requires add_A=True "
                             "(broken-as-shipped upstream otherwise)")
        self._build_backbone(num_class, num_point, num_person, in_channels,
                             adj, adaptive, attention, kernel_size, pad,
                             model_layers, backbone_dim, "bn", drop_out,
                             dtype, num_frame, sync_axis)
        self.trans_seq, self.seq, self.fork = trans_seq, seq, fork
        self.add_A = add_A
        self.classifier_type = classifier_type
        ch, t2 = self.channels, self.backbone_frames
        t_dim, s_dim = num_point * ch, t2 * ch
        rel = fork and "rel" in pos_emb
        if "CLS" in classifier_type:
            self.cls_token = nn.Parameter(torch.empty(1, 1, t_dim))
        self.t_pos_encoder = PosEncoding(_pos_kind(pos_enc), t_dim)
        common = dict(dropout=dropout, activation=activation,
                      pre_norm=prenorm, bias=False, attn_bias=fork)
        self.t_trans_enc_layers = nn.ModuleList(
            TransformerEncoderLayer(t_dim, t_num_heads,
                                    t_ffn_dim * num_point,
                                    rel_pos_len=t_length if rel else 0,
                                    **common)
            for _ in range(num_layers))
        s_layer = dict(dim=s_dim, num_heads=s_num_heads,
                       dim_feedforward=s_ffn_dim * trans_len,
                       rel_pos_len=s_length if rel else 0, **common)
        alpha = {"True": 0.0, "zero": 0.0, "one": 1.0}.get(add_Aa)
        layers = []
        for _ in range(num_layers):
            if add_A and seq.startswith("sa"):
                sub = {f"subset{a}": SubsetLayer(pa=self.adj[a], alpha=alpha,
                                                 **s_layer)
                       for a in range(self.adj.shape[0])}
                if "v3" in trans_seq:
                    sub["sa_norm"] = layer_norm(s_dim)
                layers.append(nn.ModuleDict(sub))
            else:
                layers.append(TransformerEncoderLayer(**s_layer))
        self.s_trans_enc_layers = nn.ModuleList(layers)
        self.sa_norm = (layer_norm(s_dim) if add_A and "v3" not in trans_seq
                        and trans_seq.startswith("sa") else None)
        self.res_norm = layer_norm(t_dim) if "res" in trans_seq else None
        self.cls_pool_fc = (nn.utils.skip_init(nn.Linear, t_dim, t_dim)
                            if "POOL" in classifier_type else None)
        self.mt_drop = Dropout(multi_trans_dropout)
        self.res_drop = Dropout(res_dropout)
        self._head(t_dim)
        self._finish(device, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if "CLS" in self.classifier_type:
            init.normal(1.0)(self.cls_token, generator)
        if self.cls_pool_fc is not None:
            init.lecun_normal(self.cls_pool_fc.weight, generator)
            with torch.no_grad():
                self.cls_pool_fc.bias.zero_()
        super().reset_parameters(generator)

    def _subset_outputs(self, z: torch.Tensor, i: int) -> List[torch.Tensor]:
        outs = []
        for name, layer in self.s_trans_enc_layers[i].items():
            if name == "sa_norm":
                continue
            g_attn = alpha = None
            if not self.fork:
                # bug-compatible: torch's MHA takes no injection
                # (aagcn_v34.py:115-117), the priors have no effect
                pass
            elif "v3" in self.trans_seq:
                g_attn, alpha = layer.PA, layer.alpha
            else:
                g_attn = layer.PA * (layer.alpha if layer.alpha is not None
                                     else 1.0)
            outs.append(layer(z, alpha=alpha, global_attn=g_attn)[0])
        return outs

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        y, n, m = self._features(x)
        nm, t2, v2, ch = y.shape
        _check_frames(self, t2, x)
        t_dim, s_dim = v2 * ch, t2 * ch
        has_cls = "CLS" in self.classifier_type
        tokens = y.reshape(nm, t2, t_dim)
        if has_cls:
            tokens = torch.cat([self.cls_token.expand(nm, 1, -1), tokens], 1)
        tokens = self.t_pos_encoder(tokens)

        def strip(tok):
            return tok[:, 1:] if has_cls else tok

        def to_joints(body):
            return body.reshape(nm, t2, v2, ch).permute(0, 2, 1, 3).reshape(
                nm, v2, s_dim)

        def from_joints(z):
            return z.reshape(nm, v2, t2, ch).permute(0, 2, 1, 3).reshape(
                nm, t2, t_dim)

        def reattach(body, prev):
            return torch.cat([prev[:, :1], body], 1) if has_cls else body

        seq = self.seq
        for i in range(len(self.t_trans_enc_layers)):
            t_layer = self.t_trans_enc_layers[i]
            if seq == "t-s":
                x1 = t_layer(tokens)[0]
                z = self.s_trans_enc_layers[i](to_joints(strip(x1)))[0]
                x2 = reattach(from_joints(z), x1)
            elif seq in ("s-t", "s-t-res"):
                z = self.s_trans_enc_layers[i](to_joints(strip(tokens)))[0]
                x2 = t_layer(reattach(from_joints(z), tokens))[0]
            else:  # 'sa-t', 'sa-t-res'
                z = to_joints(strip(tokens))
                if self.add_A:
                    outs = self._subset_outputs(z, i)
                else:
                    # a single PA-less spatial layer (aagcn_v34.py:344-353)
                    outs = [self.s_trans_enc_layers[i](z)[0]]
                s_sum = sum(outs)
                if "v3" in self.trans_seq:
                    z = self.s_trans_enc_layers[i]["sa_norm"](
                        self.mt_drop(s_sum))
                else:
                    z = z + self.mt_drop(s_sum)
                    if self.sa_norm is not None:
                        z = self.sa_norm(z)
                x2 = t_layer(reattach(from_joints(z), tokens))[0]
            if self.res_norm is not None:
                tokens = self.res_norm(tokens + self.res_drop(x2))
            else:
                tokens = x2
        flat = tokens.reshape(n, -1, t_dim)
        if has_cls:
            feat = flat[:, 0]
            if self.cls_pool_fc is not None:
                feat = torch.tanh(self.cls_pool_fc(feat))
        else:
            feat = flat.mean(dim=1)
        logits = self._classify(feat)
        return (logits, None) if return_attention else logits


class AdaptiveGCNv3(nn.Module):
    """Per-FRAME adaptive attention GCN (reference aagcn_v30.py:61-99;
    aagcn_versions.py:786-826): a1_k = PA_k + alpha * softmax_v(theta_k
    phi_k / Ci) for each frame. phi is taken as the reference takes it: its
    (N, Ci, T, V) tensor viewed as (N*T, Ci, V) without a permute, a view
    that mixes channels and frames (reproduced from a contiguous tensor
    in that layout). The unit's `conv_d` is used, not registered."""

    def __init__(self, in_channels: int, out_channels: int,
                 inter_channels: int, adj: np.ndarray, conv_d):
        super().__init__()
        k = adj.shape[0]
        self.adj = np.asarray(adj, np.float32)
        self.inter_c = inter_channels
        self.PA = nn.Parameter(torch.from_numpy(self.adj.copy()))
        self.alpha = nn.Parameter(torch.zeros(1))
        self.conv_a = nn.ModuleList(
            PointwiseConv(in_channels, inter_channels) for _ in range(k))
        self.conv_b = nn.ModuleList(
            PointwiseConv(in_channels, inter_channels) for _ in range(k))
        self.conv_d = tuple(conv_d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.PA.copy_(torch.from_numpy(self.adj))
            self.alpha.zero_()
        for m in (*self.conv_a, *self.conv_b):
            init.kaiming_normal_fan_out(m.weight, generator)
            init.constant(0.0)(m.bias, generator)

    def _attention(self, theta: torch.Tensor, phi: torch.Tensor,
                   k: int) -> torch.Tensor:
        nm, t, v, ci = theta.shape
        theta = theta.reshape(nm * t, v, ci)
        phi = phi.permute(0, 3, 1, 2).contiguous().reshape(nm * t, ci, v)
        att = torch.softmax(theta @ phi / ci, dim=-2)
        return (self.PA[k][None] + att * self.alpha).reshape(nm, t, v, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = 0
        for k in range(self.PA.shape[0]):
            a1 = self._attention(self.conv_a[k](x), self.conv_b[k](x), k)
            agg = torch.einsum("btvc,btvw->btwc", x, a1)
            y = y + self.conv_d[k](agg)
        return y


class AdaptiveGCNv2(AdaptiveGCNv3):
    """Per-sample adaptive attention GCN (reference aagcn_v30.py:22-58;
    aagcn_versions.py:829-858): the base AdaptiveGCN's math,
    a1_k = PA_k + alpha * softmax_v(sum_{t,c} theta_k phi_k / (Ci*T))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        y = 0
        for k in range(self.PA.shape[0]):
            theta, phi = self.conv_a[k](x), self.conv_b[k](x)
            logits = torch.einsum("btvc,btwc->bvw", theta, phi) \
                / (self.inter_c * t)
            a1 = self.PA[k][None] + torch.softmax(logits, dim=-2) \
                * self.alpha
            agg = torch.einsum("btvc,bvw->btwc", x, a1)
            y = y + self.conv_d[k](agg)
        return y


class GCNUnitLocal(nn.Module):
    """v30's spatial layer (reference aagcn_v30.py:102-124;
    aagcn_versions.py:861-879): the adaptive GCN ('v2' or 'v3'), BN with
    weight 1e-6 at init, the identity residual, ReLU; no STC attention."""

    def __init__(self, dim: int, adj: np.ndarray, gcn_version: str = "v3",
                 coff_embedding: int = 4):
        super().__init__()
        if gcn_version not in ("v2", "v3"):
            raise ValueError(f"unknown gcn_trans_unit {gcn_version!r}")
        k = adj.shape[0]
        self.conv_d = nn.ModuleList(PointwiseConv(dim, dim) for _ in range(k))
        cls = AdaptiveGCNv2 if gcn_version == "v2" else AdaptiveGCNv3
        self.agcn = cls(dim, dim, dim // coff_embedding, adj, self.conv_d)
        self.bn = BatchNorm(dim, scale_init_value=1e-6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.conv_d:
            init.kaiming_normal_fan_out(m.weight, generator)
            init.constant(0.0)(m.bias, generator)
        self.agcn.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.agcn(x)) + x)


class AAGCNv30(_Version):
    """Reference aagcn_v30.py Model: GCN-spatial (`GCNUnitLocal`) and
    transformer-temporal layers interleaved over patchified AAGCN
    features (aagcn_versions.py:882-958). The frame tokens are V*C wide,
    which `t_model_dim * num_point` must equal."""

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3, adj=None,
                 adaptive: bool = True, attention: bool = True,
                 kernel_size: int = 9, pad: bool = True,
                 backbone_dim: int = 64, gcn_trans_unit: str = "v3",
                 t_num_heads: int = 2, t_model_dim: int = 64,
                 t_ffn_dim: int = 256, t_dropout: float = 0.0,
                 t_activation: str = "gelu", t_prenorm: bool = False,
                 num_layers: int = 3, pos_enc: str = "True",
                 classifier_type: str = "CLS", drop_out: float = 0.0,
                 model_layers: int = 101, sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_classifier(classifier_type, ("CLS", "GAP"))
        self._build_backbone(num_class, num_point, num_person, in_channels,
                             adj, adaptive, attention, kernel_size, pad,
                             model_layers, backbone_dim, "bn", drop_out,
                             dtype, num_frame, sync_axis)
        self.classifier_type = classifier_type
        t_dim = t_model_dim * num_point
        if t_dim != num_point * self.channels:
            raise ValueError(
                f"t_model_dim {t_model_dim} x {num_point} joints must equal "
                f"the frame tokens' width, {self.channels} x {num_point}")
        if classifier_type == "CLS":
            self.cls_token = nn.Parameter(torch.empty(1, 1, t_dim))
        self.t_pos_encoder = PosEncoding(_pos_kind(pos_enc), t_dim)
        self.s_trans_enc_layers = nn.ModuleList(
            GCNUnitLocal(self.channels, self.adj, gcn_trans_unit)
            for _ in range(num_layers))
        sync_batch_norms(self.s_trans_enc_layers, sync_axis)
        self.t_trans_enc_layers = nn.ModuleList(
            TransformerEncoderLayer(t_dim, t_num_heads, t_ffn_dim,
                                    t_dropout, t_activation, t_prenorm)
            for _ in range(num_layers))
        self._head(t_dim)
        self._finish(device, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.classifier_type == "CLS":
            init.normal(1.0)(self.cls_token, generator)
        for unit in self.s_trans_enc_layers:
            unit.reset_parameters(generator)
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        y, n, m = self._features(x)
        _, t2, v2, ch = y.shape
        has_cls = self.classifier_type == "CLS"
        tokens = y.reshape(n, m * t2, v2 * ch)
        if has_cls:
            tokens = torch.cat([self.cls_token.expand(n, 1, -1), tokens], 1)
        tokens = self.t_pos_encoder(tokens)
        attn = []
        for unit, t_layer in zip(self.s_trans_enc_layers,
                                 self.t_trans_enc_layers):
            body = tokens[:, 1:] if has_cls else tokens
            x0 = unit(body.reshape(n * m, t2, v2, ch))
            body = x0.reshape(n, m * t2, v2 * ch)
            tokens = torch.cat([tokens[:, :1], body], 1) if has_cls else body
            tokens, a = t_layer(tokens)
            attn.append(a)
        logits = self._classify(_readout(tokens, self.classifier_type))
        return (logits, attn) if return_attention else logits


VERSIONS = {"aagcn_v17": AAGCNv17, "aagcn_v24": AAGCNv24,
            "aagcn_v30": AAGCNv30, "aagcn_v31": AAGCNv31,
            "aagcn_v34": AAGCNv34}
