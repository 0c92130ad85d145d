"""AAGCNTransformer — transformer heads over a shallow AAGCN backbone
(port of agcn_tpu/models/aagcn_transformer.py; the reference's
aagcn_v29-v37 family, `model.aagcn_v37.Model`).

The backbone (data BN, then `model_layers` 101/102/103 or any AAGCN layer
plan of `TCNGCNUnit`s) runs in `dtype`; its (B*M, T, V, C) features are
cast to fp32 and re-tokenized for transformer encoders, which run in fp32:

- 'temporal': frames are tokens, joints folded into the width (V*C);
- 'spatial': the frame-averaged joints are tokens (C);
- 'dual' (v36/v37): frame tokens (joints max-pooled) and joint tokens
  (frames max-pooled) through two encoders, each with its CLS token,
  optionally fused by CLS cross-attention (`cross_fusion`), read out and
  concatenated.

Then the person mean, `drop_out` and `fc`. `forward(x)` returns the
logits; `forward(x, return_attention=True)` returns (logits, attention)
with the structure of the JAX model's `aux["attn"]`: a list of each
layer's (B*M, H, L, L) softmax weights, or {"temporal": [...],
"spatial": [...]} in 'dual'.

The learned position tables are sized as the JAX model sizes them at
init, from its input: tokens + 1 rows (CLS included). Torch builds the
parameters before any input, so `num_frame` names the input's frames (the
trainer passes its data's T, the server its window); a table built for
more frames serves any shorter input, and loading weights made for
another T raises with both Ts. The encoders' layers are named layer1 ..
layerN (the LLRD multipliers' tokens); parameters carry the names that
`utils/weights.aagcn_transformer_state_dict_from_variables` writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from agcn_tpu_torch.models.aagcn import TCNGCNUnit, layer_plan
from agcn_tpu_torch.ops import BatchNorm
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import sync_batch_norms
from agcn_tpu_torch.ops.attention import (CrossTransformer, Dropout,
                                          TransformerEncoder)
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

MODES = ("temporal", "spatial", "dual")


class AAGCNTransformer(nn.Module):
    """Built on the CPU, initialized from `generator` (seed 0 when None)
    and moved to `device`, `cuda` unless the caller names another. Every
    dropout (the encoders' and `drop_out`) draws its masks from one
    generator on that device, seeded from `generator` (`dropout_seed`;
    the train step reseeds it for each update, `train/steps.seed_dropout`).
    """

    takes_num_frame = True  # build_model passes the input's frames

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, in_channels: int = 3,
                 adj: Optional[np.ndarray] = None, model_layers: int = 101,
                 backbone_channels: int = 64, adaptive: bool = True,
                 attention: bool = False, kernel_size: int = 9,
                 stride: int = 1, mode: str = "temporal",
                 num_layers: int = 3, num_heads: int = 8,
                 dim_feedforward: int = 512, dropout: float = 0.1,
                 pre_norm: bool = True, pos_enc: str = "abs",
                 use_cls_token: bool = True, cross_fusion: bool = False,
                 drop_out: float = 0.0, sync_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, num_frame: int = 300,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if adj is None:
            raise ValueError("adj: the (K, V, V) adjacency stack is required")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if pos_enc not in ("abs", "cos", "none"):
            raise ValueError(f"unknown pos_enc {pos_enc!r}")
        self.mode = mode
        self.dtype = dtype
        self.num_class = num_class
        self.num_frame = num_frame
        self.use_cls_token = use_cls_token
        self.data_bn = BatchNorm(num_person * num_point * in_channels)
        plan = layer_plan(model_layers, backbone_channels)
        self.block_names = []
        c, t = in_channels, num_frame
        for name in [f"l{i}" for i in range(1, 11)]:
            if name not in plan:
                continue
            ch, st, residual, pd = plan[name]
            block = TCNGCNUnit(c, ch, adj,
                               stride=stride if st is None else st,
                               residual=residual, kernel_size=kernel_size,
                               pad=True if pd is None else pd, dtype=dtype,
                               adaptive=adaptive, attention=attention)
            self.add_module(name, block)
            self.block_names.append(name)
            conv = block.tcn1.conv
            t = (t + 2 * conv.pad - conv.weight.shape[2]) // conv.stride + 1
            c = ch
        # SyncBN on the data norm and the AAGCN units (JAX :88, :106); the
        # encoders' norms take no axis there either
        if sync_axis is not None:
            for name in ["data_bn"] + self.block_names:
                sync_batch_norms(getattr(self, name), sync_axis)
        # frames after the backbone, and the tokens each encoder sees
        self.backbone_frames = t
        cls = 1 if use_cls_token else 0
        encoder = dict(num_layers=num_layers, num_heads=num_heads,
                       dim_feedforward=dim_feedforward, dropout=dropout,
                       pre_norm=pre_norm,
                       pos_enc=None if pos_enc == "none" else pos_enc)
        self.cls_names = []
        if mode == "dual":
            self.temporal_encoder = TransformerEncoder(
                c, max_len=t + cls + 1, **encoder)
            self.spatial_encoder = TransformerEncoder(
                c, max_len=num_point + cls + 1, **encoder)
            if use_cls_token:
                self.cls_token_t = nn.Parameter(torch.empty(1, 1, c))
                self.cls_token_s = nn.Parameter(torch.empty(1, 1, c))
                self.cls_names = ["cls_token_t", "cls_token_s"]
            self.cross_fusion = CrossTransformer(c, num_heads) \
                if cross_fusion and use_cls_token else None
            width = 2 * c
        else:
            width = num_point * c if mode == "temporal" else c
            tokens = t if mode == "temporal" else num_point
            self.encoder = TransformerEncoder(width, max_len=tokens + cls + 1,
                                              **encoder)
            if use_cls_token:
                self.cls_token = nn.Parameter(torch.empty(1, 1, width))
                self.cls_names = ["cls_token"]
        self.fc_drop = Dropout(drop_out)
        self.fc = nn.utils.skip_init(nn.Linear, width, num_class)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.reset_parameters(generator)
        self.to(device)
        self.dropout_generator = None
        if drop_out or dropout:
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)
            for m in self.modules():
                if isinstance(m, Dropout):
                    m.generator = self.dropout_generator

    def encoders(self) -> Dict[str, TransformerEncoder]:
        names = (("temporal_encoder", "spatial_encoder")
                 if self.mode == "dual" else ("encoder",))
        return {n: getattr(self, n) for n in names}

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.block_names:
            getattr(self, name).reset_parameters(generator)
        for name in self.cls_names:
            init.normal(0.02)(getattr(self, name), generator)
        for enc in self.encoders().values():
            enc.reset_parameters(generator)
        if self.mode == "dual" and self.cross_fusion is not None:
            self.cross_fusion.reset_parameters(generator)
        init.fc_init(self.num_class)(self.fc.weight, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """torch's load, after a check that the frame position table was
        made for this model's frames."""
        enc = "temporal_encoder" if self.mode == "dual" else "encoder"
        key = f"{enc}.pos_enc.embedding"
        got = state_dict.get(key)
        if self.mode != "spatial" and got is not None \
                and hasattr(getattr(self, enc).pos_enc, "embedding"):
            own = getattr(self, enc).pos_enc.embedding.shape[0]
            if got.shape[0] != own:
                extra = own - self.backbone_frames
                raise ValueError(
                    f"{key}: the weights' position table has "
                    f"{got.shape[0]} rows, made for T = "
                    f"{got.shape[0] - extra} frames after the backbone; "
                    f"this model's has {own}, for T = "
                    f"{self.backbone_frames} (num_frame={self.num_frame}). "
                    "Build the model for the weights' T.")
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _with_cls(self, tokens: torch.Tensor, name: str) -> torch.Tensor:
        if not self.use_cls_token:
            return tokens
        cls = getattr(self, name).expand(tokens.shape[0], 1, -1)
        return torch.cat([cls, tokens], dim=1)

    def _readout(self, encoded: torch.Tensor) -> torch.Tensor:
        return encoded[:, 0] if self.use_cls_token else encoded.mean(dim=1)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        n, c, t, v, m = x.shape
        # data BN + person fold (reference BaseModel.forward_preprocess)
        y = x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * c)
        y = self.data_bn(y)
        y = y.reshape(n, t, m, v, c).permute(0, 2, 1, 3, 4).reshape(
            n * m, t, v, c)
        if self.dtype is not None:
            y = y.to(self.dtype)
        for name in self.block_names:
            y = getattr(self, name)(y)
        y = y.float()
        bm, t2, v2, ch = y.shape
        attn: Union[List[torch.Tensor], Dict[str, List[torch.Tensor]]]
        if self.mode == "dual":
            # torch.amax, which tools/grad_parity.py's AmaxProbe replays
            t_tokens = self._with_cls(torch.amax(y, dim=2), "cls_token_t")
            t_enc, t_attn = self.temporal_encoder(t_tokens)
            s_tokens = self._with_cls(torch.amax(y, dim=1), "cls_token_s")
            s_enc, s_attn = self.spatial_encoder(s_tokens)
            if self.cross_fusion is not None:
                t_enc, s_enc = self.cross_fusion(t_enc, s_enc)
            feat = torch.cat([self._readout(t_enc), self._readout(s_enc)],
                             dim=-1)
            attn = {"temporal": t_attn, "spatial": s_attn}
        else:
            tokens = (y.reshape(bm, t2, v2 * ch) if self.mode == "temporal"
                      else y.mean(dim=1))
            enc, attn = self.encoder(self._with_cls(tokens, "cls_token"))
            feat = self._readout(enc)
        # person mean (reference forward_postprocess)
        feat = feat.reshape(n, m, -1).mean(dim=1)
        logits = self.fc(self.fc_drop(feat))
        return (logits, attn) if return_attention else logits
