"""SGNTransformer — the pure-transformer SGN (v15) (port of
agcn_tpu/models/sgn_transformer.py; reference
model/architecture/sgn/sgn_v15.py).

The input is the SGN loader's (B, seg, V*C) segments. In order:
position and velocity embeddings as in SGN (`SGNEmbedding` behind a
DataNorm; velocity x[t] - x[t-1] with a leading zero frame), fused by
concatenation (`input_emb_fusion` 0) or sum (1); the one-hot joint
embedding, concatenated (`semantic_joint_fusion` 0) or added (1); the
one-hot frame embedding, added before the spatial encoder
(`semantic_frame_location` 1) or after it (0); a *spatial* encoder over
the joints of each frame (frames folded into the batch), the spatial
max-pool (`spatial_maxpool` 1, else the joints flattened into the
width), a *temporal* encoder over the frames, the temporal max-pool
(`temporal_maxpool` 1, else flattened), the class embedding
(`semantic_class`), dropout and `fc`.

Each encoder branches on its own kwargs, as the reference does
(sgn_v15.py:441-446): `norm` in `spatial_mha` / `temporal_mha` selects
the lucidrains encoder (`ops/attention.LucidTransformer`, under the
reference's `<encoder>.transformer`), otherwise torch's
TransformerEncoderLayer stack (`ops/attention.TransformerEncoder`, layers
`layer1` .. `layerN`, constant width); a mixed config is legal. The frame
embedding is as wide as the tensor it is added to: c3 after a lucid
spatial encoder at location 0, otherwise the running width (agcn_tpu
sgn_transformer.py:117-131).

`forward(x)` returns (logits, {"spatial_attn": [...], "temporal_attn":
[...]}), each layer's softmax weights, as the JAX model does. The one-hot
tables are the reference's buffers, so the model is built for the
loader's `seg` (`num_segment`). The max-pools call `torch.amax` and the
ReLUs `torch.relu` (the calls tools/grad_parity.py's probes replay).
The model runs in fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from agcn_tpu_torch.models.sgn import C1, C2, C3, C4, OneHot, SGNEmbedding
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.attention import (Dropout, LucidTransformer,
                                          TransformerEncoder)
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class LucidMHA(nn.Module):
    """The reference's SpatialMHA / TemporalMHA around the lucid encoder:
    its parameters sit under `transformer`."""

    def __init__(self, kwargs: Dict[str, Any], in_dim: int):
        super().__init__()
        self.transformer = LucidTransformer.from_mha_kwargs(kwargs, in_dim)
        self.out_dim = self.transformer.out_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.transformer.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        return self.transformer(x)


def _encoder(kwargs: Dict[str, Any], width: int) -> nn.Module:
    """The lucid encoder where `norm` is in the kwargs, else the torch-style
    stack at the running width (agcn_tpu sgn_transformer.py:141-151)."""
    if "norm" in kwargs:
        return LucidMHA(kwargs, width)
    return TransformerEncoder(
        width, num_layers=kwargs.get("num_layers", 1),
        num_heads=kwargs.get("nhead", 1),
        dim_feedforward=kwargs.get("dim_feedforward", width * 2),
        dropout=kwargs.get("dropout", 0.1),
        activation=kwargs.get("activation", "relu"),
        pre_norm=kwargs.get("pre_norm", False))


def _out_width(encoder: nn.Module, width: int) -> int:
    """An encoder's output width: the lucid encoder's last layer's, the
    torch-style stack's input width."""
    return encoder.out_dim if isinstance(encoder, LucidMHA) else width


class SGNTransformer(nn.Module):
    """Built on the CPU, initialized from `generator` (seed 0 when None)
    and moved to `device`, `cuda` unless the caller names another. Every
    dropout (the encoders' and `dropout` before fc) draws its masks from
    one generator on that device, seeded from `generator` (`dropout_seed`;
    the train step reseeds it for each update, `train/steps.seed_dropout`).
    """

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_segment: int = 20, in_channels: int = 3,
                 use_bias: bool = True, dropout: float = 0.0,
                 c_multiplier: Union[float, Sequence[float]] = 1,
                 input_position: int = 1, input_velocity: int = 1,
                 semantic_joint: int = 1, semantic_frame: int = 1,
                 semantic_class: int = 0, input_emb_fusion: int = 1,
                 semantic_joint_fusion: int = 0,
                 semantic_frame_location: int = 0,
                 spatial_mha: Optional[Dict[str, Any]] = None,
                 temporal_mha: Optional[Dict[str, Any]] = None,
                 spatial_maxpool: int = 1, temporal_maxpool: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"SGNTransformer computes in fp32 (as in the JAX package); "
                f"dtype {dtype} asked")
        if input_position <= 0 and input_velocity <= 0:
            raise ValueError("SGNTransformer needs input_position or "
                             "input_velocity")
        m = (tuple(c_multiplier) if isinstance(c_multiplier, (list, tuple))
             else (c_multiplier,) * 4)
        c1, c2, c3, c4 = (int(c * k) for c, k in zip((C1, C2, C3, C4), m))
        v, t = num_point, num_segment
        self.num_class = num_class
        self.num_point = num_point
        self.num_segment = num_segment
        self.in_channels = in_channels
        self.input_emb_fusion = input_emb_fusion
        self.semantic_joint_fusion = semantic_joint_fusion
        self.frame_location = semantic_frame_location
        self.spatial_maxpool = spatial_maxpool
        self.temporal_maxpool = temporal_maxpool
        spatial_mha = dict(spatial_mha or {})
        temporal_mha = dict(temporal_mha or {})

        self.feature_extractor = nn.ModuleDict()
        for name, mode in (("pos_embed", input_position),
                           ("vel_embed", input_velocity)):
            if mode > 0:
                self.feature_extractor[name] = SGNEmbedding(
                    in_channels, c1, mode, use_bias,
                    in_norm_features=in_channels * v)
        both = input_position > 0 and input_velocity > 0
        width = 2 * c1 if both and input_emb_fusion == 0 else c1
        self.semantic_embedding = nn.ModuleDict()
        if semantic_joint > 0:
            # the joint embedding as wide as the fused input
            # (sgn_v15.py:165-168)
            sem_out = c2 if input_emb_fusion == 0 else c1
            self.semantic_embedding["spa_embedding"] = SGNEmbedding(
                v, sem_out, semantic_joint, use_bias)
            self.semantic_embedding["spa_onehot"] = OneHot(v, t, mode=0)
            if semantic_joint_fusion == 0:
                width += sem_out
        d_model = width
        self.spatial_mha = _encoder(spatial_mha, d_model)
        s_lucid = isinstance(self.spatial_mha, LucidMHA)
        if semantic_frame > 0:
            tem_out = (c3 if s_lucid and semantic_frame_location == 0
                       else d_model)
            self.semantic_embedding["tem_embedding"] = SGNEmbedding(
                t, tem_out, semantic_frame, use_bias)
            self.semantic_embedding["tem_onehot"] = OneHot(t, v, mode=1)
        width = _out_width(self.spatial_mha, d_model)
        if spatial_maxpool != 1:
            width *= v
        self.temporal_mha = _encoder(temporal_mha, width)
        width = _out_width(self.temporal_mha, width)
        if temporal_maxpool != 1:
            width *= t
        if semantic_class > 0:
            t_lucid = isinstance(self.temporal_mha, LucidMHA)
            self.semantic_embedding["cls_embedding"] = SGNEmbedding(
                1, c4 if t_lucid else width, semantic_class, use_bias)
            self.semantic_embedding["cls_onehot"] = OneHot(1, 1, mode=2)
        self.fc_drop = Dropout(dropout)
        self.fc = nn.utils.skip_init(nn.Linear, width, num_class)

        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.reset_parameters(generator)
        self.to(device)
        self.dropout_generator = None
        drops = [mod for mod in self.modules() if isinstance(mod, Dropout)]
        if any(d.p > 0 for d in drops):
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)
            for d in drops:
                d.generator = self.dropout_generator

    def reset_parameters(self, generator: torch.Generator) -> None:
        for emb in self.feature_extractor.values():
            emb.reset_parameters(generator)
        for emb in self.semantic_embedding.values():
            if isinstance(emb, SGNEmbedding):
                emb.reset_parameters(generator)
        self.spatial_mha.reset_parameters(generator)
        self.temporal_mha.reset_parameters(generator)
        init.torch_default(self.fc.in_features)(self.fc.weight, generator)
        init.torch_default(self.fc.in_features)(self.fc.bias, generator)

    def forward(self, x: torch.Tensor):
        b, t, dim = x.shape
        v = self.num_point
        if t != self.num_segment:
            raise ValueError(
                f"SGNTransformer built for {self.num_segment} segments (the "
                f"one-hot frame table) got an input of {t}; build it with "
                f"num_segment={t}")
        x = x.reshape(b, t, v, dim // v)[..., :self.in_channels]
        dif = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:] - x[:, :-1]],
                        dim=1)
        fe, se = self.feature_extractor, self.semantic_embedding
        streams = [fe[name](inp) for name, inp in (("pos_embed", x),
                                                   ("vel_embed", dif))
                   if name in fe]
        if len(streams) == 1:
            feat = streams[0]
        elif self.input_emb_fusion == 0:
            feat = torch.cat(streams, dim=-1)
        else:
            feat = streams[0] + streams[1]
        if "spa_embedding" in se:
            spa = se["spa_embedding"](se["spa_onehot"].table())
            spa = spa.expand(b, -1, -1, -1)
            feat = (torch.cat([feat, spa], dim=-1)
                    if self.semantic_joint_fusion == 0 else feat + spa)
        tem = (se["tem_embedding"](se["tem_onehot"].table())
               if "tem_embedding" in se else None)
        if tem is not None and self.frame_location == 1:
            feat = feat + tem
        y, spa_attn = self.spatial_mha(feat.reshape(b * t, v, -1))
        feat = y.reshape(b, t, v, -1)
        if tem is not None and self.frame_location == 0:
            feat = feat + tem
        feat = (torch.amax(feat, dim=2) if self.spatial_maxpool == 1
                else feat.reshape(b, t, -1))
        y, tem_attn = self.temporal_mha(feat)
        y = (torch.amax(y, dim=1) if self.temporal_maxpool == 1
             else y.reshape(b, -1))
        if "cls_embedding" in se:
            y = y + se["cls_embedding"](se["cls_onehot"].table()).reshape(
                1, -1)
        logits = self.fc(self.fc_drop(y))
        return logits, {"spatial_attn": spa_attn, "temporal_attn": tem_attn}
