"""The original SGN (microsoft/SGN): port of agcn_tpu/models/sgn_original.py
(reference model/architecture/sgn/archiv/sgn.py, the `model.sgn.SGN` of
the reference's openpose recipes).

- position and velocity embeddings (`embed`: the (c, v) DataNorm, then
  1x1 (in -> 64) -> relu -> 1x1 (64 -> c1) -> relu); velocity is x[t] -
  x[t-1] with a leading zero frame;
- the one-hot joint embedding (-> c1), concatenated with their sum, and
  the one-hot frame embedding (-> c3), added after the GCN stack;
- ONE G = softmax_w(g1(y) g2(y)^T) per frame, shared by three units
  relu(bn(w(G y) + w1(y))), w bias-less and starting at zero;
- the spatial max-pool, a windowed max-pool to `seg` frames when the
  input has another T, the 1x3 temporal conv -> BN -> relu -> dropout2d
  -> 1x1 (c3 -> 2 c3) -> BN -> relu, the temporal max-pool and `fc`.

`forward(x)` takes (B, T, V*C) (or (B, T, V, C)) and returns (logits, G),
as the JAX model does. Layout is channels-last (B, T, V, C); the module
and parameter names are the reference's (the keys
`utils/weights.sgn_original_state_dict_from_variables` writes), each 1x1
conv keeps its (out, in, 1, 1) kernel. The one-hot frame table is built
for `num_frame` frames (the loader's `seg` by default): the reference
sizes it by `seg` and fails on another T, the JAX model by its init
input. fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from agcn_tpu_torch.models.sgn import DataNorm
from agcn_tpu_torch.ops import BatchNorm
from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.attention import Dropout
from agcn_tpu_torch.ops.gcn import frame_aggregate, frame_attention
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

C1, C2, C3 = 64, 128, 256


class Cnn1x1(nn.Module):
    """cnn1x1 (archiv/sgn.py:146-153): the 1x1 Conv2d `cnn`, applied to
    the last axis as a matmul. Kaiming-normal (fan out) weights and
    torch's default bias (archiv/sgn.py:57-60)."""

    def __init__(self, dim1: int, dim2: int, bias: bool = True):
        super().__init__()
        self.cnn = nn.utils.skip_init(nn.Conv2d, dim1, dim2, 1, bias=bias)

    def reset_parameters(self, generator: torch.Generator,
                         kernel=init.kaiming_normal_fan_out) -> None:
        kernel(self.cnn.weight, generator)
        if self.cnn.bias is not None:
            init.torch_default(self.cnn.in_channels)(self.cnn.bias,
                                                     generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.cnn.weight
        return F.linear(x, w.view(w.shape[0], w.shape[1]), self.cnn.bias)


class Embed(nn.Module):
    """embed (archiv/sgn.py:119-143): [norm_data] -> 1x1 (in -> 64) ->
    relu -> 1x1 (64 -> out) -> relu, as `cnn.0..`; the hidden width is 64
    whatever the output's."""

    def __init__(self, dim: int, dim1: int, norm_features: int = 0,
                 bias: bool = True):
        super().__init__()
        layers = [DataNorm(norm_features)] if norm_features else []
        layers += [Cnn1x1(dim, 64, bias), nn.ReLU(), Cnn1x1(64, dim1, bias),
                   nn.ReLU()]
        self.cnn = nn.Sequential(*layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.cnn:
            if isinstance(layer, Cnn1x1):
                layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x)


class GCNSpa(nn.Module):
    """gcn_spa (archiv/sgn.py:184-197): relu(bn(w(G x) + w1(x))); w is
    bias-less and starts at zero (:62-64), so each unit starts as a 1x1
    projection of its input."""

    def __init__(self, in_feature: int, out_feature: int,
                 bias: bool = True):
        super().__init__()
        self.bn = BatchNorm(out_feature)
        self.w = Cnn1x1(in_feature, out_feature, bias=False)
        self.w1 = Cnn1x1(in_feature, out_feature, bias=bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.reset_parameters(generator, kernel=init.constant(0.0))
        self.w1.reset_parameters(generator)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        y = self.w(frame_aggregate(x, g)) + self.w1(x)
        return torch.relu(self.bn(y))


class ComputeG(nn.Module):
    """compute_g_spa (archiv/sgn.py:199-215): softmax over the source
    joint of g1(x) g2(x)^T, per frame."""

    def __init__(self, dim1: int, dim2: int, bias: bool = True):
        super().__init__()
        self.g1 = Cnn1x1(dim1, dim2, bias)
        self.g2 = Cnn1x1(dim1, dim2, bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.g1.reset_parameters(generator)
        self.g2.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frame_attention(self.g1(x), self.g2(x), "softmax")


class Local(nn.Module):
    """local (archiv/sgn.py:155-178) after its max-pool: cnn1 (1x3 over T)
    -> bn1 -> relu -> dropout2d (train only) -> cnn2 (1x1) -> bn2 -> relu
    on the (B, T, 1, C) frame features."""

    def __init__(self, dim1: int, dim2: int, bias: bool = True,
                 dropout: float = 0.2):
        super().__init__()
        self.cnn1 = nn.utils.skip_init(nn.Conv2d, dim1, dim1, (1, 3),
                                       padding=(0, 1), bias=bias)
        self.bn1 = BatchNorm(dim1)
        self.cnn2 = nn.utils.skip_init(nn.Conv2d, dim1, dim2, 1, bias=bias)
        self.bn2 = BatchNorm(dim2)
        self.drop = Dropout(dropout, (1, 2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.kaiming_normal_fan_out(self.cnn1.weight, generator)
        if self.cnn1.bias is not None:
            init.torch_default(3 * self.cnn1.in_channels)(self.cnn1.bias,
                                                          generator)
        init.kaiming_normal_fan_out(self.cnn2.weight, generator)
        if self.cnn2.bias is not None:
            init.torch_default(self.cnn2.in_channels)(self.cnn2.bias,
                                                      generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 2, 1), self.cnn1.weight,
                     self.cnn1.bias, padding=(0, 1)).permute(0, 3, 2, 1)
        y = self.drop(torch.relu(self.bn1(y)))
        w = self.cnn2.weight
        y = F.linear(y, w.view(w.shape[0], w.shape[1]), self.cnn2.bias)
        return torch.relu(self.bn2(y))


class SGNOriginal(nn.Module):
    """The original microsoft/SGN classifier (agcn_tpu
    sgn_original.py:108-192). Built on the CPU, initialized from
    `generator` (seed 0 when None) and moved to `device`, `cuda` unless
    the caller names another. dropout2d draws from the model's generator
    on that device (`dropout_seed`; the train step reseeds it for each
    update, `train/steps.seed_dropout`)."""

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 in_channels: int = 3, seg: int = 20, use_bias: bool = True,
                 dropout: float = 0.2, num_frame: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"SGNOriginal computes in fp32 (as in the JAX package); "
                f"dtype {dtype} asked")
        device = resolve_device(device)
        self.num_class, self.num_point = num_class, num_point
        self.in_channels, self.seg = in_channels, seg
        self.num_frame = num_frame if num_frame is not None else seg
        v, t = num_point, self.num_frame
        self.joint_embed = Embed(in_channels, C1, in_channels * v, use_bias)
        self.dif_embed = Embed(in_channels, C1, in_channels * v, use_bias)
        self.spa_embed = Embed(v, C1, bias=use_bias)
        self.tem_embed = Embed(t, C3, bias=use_bias)
        self.register_buffer("spa_table", torch.eye(v)[None, None],
                             persistent=False)
        self.register_buffer("tem_table", torch.eye(t)[None, None],
                             persistent=False)
        self.compute_g1 = ComputeG(C2, C3, use_bias)
        self.gcn1 = GCNSpa(C2, C2, use_bias)
        self.gcn2 = GCNSpa(C2, C3, use_bias)
        self.gcn3 = GCNSpa(C3, C3, use_bias)
        self.cnn = Local(C3, 2 * C3, use_bias, dropout)
        self.fc = nn.utils.skip_init(nn.Linear, 2 * C3, num_class)

        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        for module in (self.joint_embed, self.dif_embed, self.spa_embed,
                       self.tem_embed, self.compute_g1, self.gcn1,
                       self.gcn2, self.gcn3, self.cnn):
            module.reset_parameters(generator)
        init.torch_default(2 * C3)(self.fc.weight, generator)
        init.torch_default(2 * C3)(self.fc.bias, generator)
        self.to(device)
        self.dropout_generator = None
        if dropout > 0.0:
            self.dropout_seed = int(torch.randint(2 ** 62, (1,),
                                                  generator=generator))
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(self.dropout_seed)
            self.cnn.drop.generator = self.dropout_generator

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        if x.dim() == 3:  # (B, T, V*C), joints-major (archiv/sgn.py:70-72)
            x = x.reshape(b, x.shape[1], self.num_point, self.in_channels)
        t = x.shape[1]
        if t != self.num_frame:
            raise ValueError(
                f"SGNOriginal built for {self.num_frame} frames (the one-hot "
                f"frame table) got an input of {t}; build it with "
                f"num_frame={t}")
        dif = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:] - x[:, :-1]],
                        dim=1)
        dy = self.joint_embed(x) + self.dif_embed(dif)
        spa = self.spa_embed(self.spa_table)  # (1, 1, V, C1)
        tem = self.tem_embed(self.tem_table).transpose(1, 2)  # (1, T, 1, C3)
        y = torch.cat([dy, spa.expand(b, t, -1, -1)], dim=-1)
        g = self.compute_g1(y)
        y = self.gcn3(self.gcn2(self.gcn1(y, g), g), g)
        y = torch.amax(y + tem, dim=2, keepdim=True)  # spatial max-pool
        if t != self.seg:
            # AdaptiveMaxPool2d((1, seg)): window i is [floor(i T / seg),
            # ceil((i + 1) T / seg)) (agcn_tpu sgn_original.py:163-172)
            y = torch.stack(
                [torch.amax(y[:, (i * t) // self.seg:
                              -(-((i + 1) * t) // self.seg)], dim=1)
                 for i in range(self.seg)], dim=1)
        y = torch.amax(self.cnn(y), dim=1).reshape(b, -1)  # temporal
        return self.fc(y), g
