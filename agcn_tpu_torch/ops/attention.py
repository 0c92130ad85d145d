"""Attention layers of the AAGCN transformer and the AAGCN versions
and SGN's transformer (port of agcn_tpu/ops/attention.py:
`PositionalEncoding` :28, `CosSinPositionalEncoding` :42, `RelPosEmb1D`
:59, `MultiheadAttention` :85, `TransformerEncoderLayer` :166,
`CrossAttention` :227, `CrossTransformer` :257, `_ChannelNorm` :287,
`LucidAttention` :307, `LucidFeedForward` :359, `LucidTransformer` :396,
`TransformerEncoder` :489).

Tokens are (B, L, D). Parameters carry torch's names
(`self_attn.in_proj_weight`, `self_attn.out_proj.*`, `linear1`,
`norm1`, ...), the names `agcn_tpu/utils/torch_import.py` reads, and the
layers of an encoder are `layer1` .. `layerN`, the tokens that the LLRD
multipliers look for (`train/optim.llrd_scales`).

As in the JAX package, and unlike torch's own layers:
- LayerNorm's epsilon is flax's 1e-6;
- pre-norm *reassigns* x = LN(x), so the residual adds onto the normed
  tokens (the reference's TransformerEncoderLayerExt);
- attention returns its per-head softmax weights (B, H, Lq, Lk);
- 'gelu' is the tanh approximation (flax `nn.gelu`).

The versions' options (models/aagcn_versions.py): a shared 1D relative
position bias (`rel_pos_len`, the skew trick), an additive logit mask,
the forked MHA's post-softmax injection (`alpha`, `global_attn`), and
layers without biases (`bias=False`: linears and LayerNorms, v32's slip;
`attn_bias=False`: the attention's projections), and a boolean `mask`
(logits where it is False set to -1e9). Dropout draws its masks from the
generator its `Dropout` module holds (the model sets it), never from
torch's global RNG.

SGN v15's lucidrains (CrossViT-style) encoder, `LucidTransformer`, keeps
the reference's module names (crossattention.py:202-304), so that a
reference state dict loads strictly: `layers.l{i}.attn.norm.fn` and
`layers.l{i}.ffn.norm.fn` (the Normalize-wrapped BatchNorm or LayerNorm),
`layers.l{i}.attn.fn.{to_q,to_k,to_v,to_out.linear,residual}`,
`layers.l{i}.ffn.fn.{net.linear1,net.linear2,residual}` and the global
`norm.fn`. Torch sizes a Linear before any input, so the encoder takes
its input width (`in_dim`); the per-layer `dims` decide, as in JAX, only
whether an attention has its residual projection.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agcn_tpu_torch.ops import initializers as init
from agcn_tpu_torch.ops.norm import BatchNorm

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def _linear(in_features: int, out_features: int,
            bias: bool = True) -> nn.Linear:
    # skip_init: nn.Linear's own init would draw from the global RNG
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              bias=bias)


def _dense_init(layer: nn.Linear, generator: torch.Generator,
                kernel=init.lecun_normal) -> None:
    """flax nn.Dense's init: `kernel` (lecun_normal by default), zero
    bias."""
    kernel(layer.weight, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


class Dropout(nn.Module):
    """Inverted dropout in train mode (flax nn.Dropout): keep with
    probability 1 - p, scale the kept values by 1 / (1 - p). The masks
    come from `generator` (on the tokens' device; None draws from torch's
    default generator of that device). `broadcast_dims` share one draw
    along those axes (flax's `broadcast_dims`: SGN's Dropout2d drops whole
    channels of a (B, T, V, C) tensor with (1, 2))."""

    def __init__(self, p: float, broadcast_dims: Tuple[int, ...] = ()):
        super().__init__()
        self.p = p
        self.broadcast_dims = tuple(broadcast_dims)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        shape = [1 if d in self.broadcast_dims else n
                 for d, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def layer_norm(dim: int, bias: bool = True) -> nn.LayerNorm:
    """flax nn.LayerNorm: epsilon 1e-6; `bias=False` keeps the scale."""
    return nn.LayerNorm(dim, eps=LN_EPS, bias=bias)


class PositionalEncoding(nn.Module):
    """Learned position table `embedding` (max_len, D), normal(0.02); adds
    its first L rows to L tokens."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(max_len, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.normal(0.02)(self.embedding, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        if n > self.embedding.shape[0]:
            raise ValueError(
                f"{n} tokens, but the position table has "
                f"{self.embedding.shape[0]} rows: build the model for this "
                "input length")
        return x + self.embedding[:n][None]


def cos_sin_table(max_len: int, dim: int) -> np.ndarray:
    """The fixed sinusoidal table of agcn_tpu attention.py:48-54 (an odd
    `dim` included)."""
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    table = np.zeros((max_len, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: (dim + 1) // 2][:dim // 2]) \
        if dim % 2 else np.cos(pos * div)
    return table


class CosSinPositionalEncoding(nn.Module):
    """Fixed sinusoidal positions (no parameter, as in the JAX package)."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        self.register_buffer("table",
                             torch.from_numpy(cos_sin_table(max_len, dim)),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        if n > self.table.shape[0]:
            raise ValueError(
                f"{n} tokens, but the position table has "
                f"{self.table.shape[0]} rows: build the model for this "
                "input length")
        return x + self.table[:n][None]


class RelPosEmb1D(nn.Module):
    """1D relative position logits by the skew trick (agcn_tpu
    attention.py:59-82, reference rel_embedding.py): a table
    `rel_pos_emb` (2 * max_len - 1, Dh), normal(0.02); the rows of the
    relative offsets -(T-1) .. T-1 of a T-token sequence, skewed into
    (T, T) absolute positions."""

    def __init__(self, max_len: int, dim_head: int):
        super().__init__()
        self.max_len = max_len
        self.rel_pos_emb = nn.Parameter(torch.empty(2 * max_len - 1,
                                                    dim_head))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.normal(0.02)(self.rel_pos_emb, generator)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        """q (B, H, T, Dh) -> (B, H, T, T) relative logits."""
        b, h, t, dh = q.shape
        start = self.max_len - t
        rel = (q * dh ** -0.5) @ self.rel_pos_emb[
            start:start + 2 * t - 1].t()  # (B, H, T, 2T-1)
        flat = F.pad(F.pad(rel, (0, 1)).reshape(b, h, 2 * t * t),
                     (0, t - 1))
        return flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


class MultiheadAttention(nn.Module):
    """Multi-head self- or cross-attention with torch's packed
    `in_proj_weight` (3D, D) (rows q | k | v) and `out_proj`, both
    xavier_normal with zero biases (none with `bias=False`), and with
    `rel_pos_len` the relative position logits `pos_emb` added to the
    scaled logits. Returns (output, the plain softmax weights (B, H, Lq,
    Lk)). The weights that multiply v are softmax * `alpha` +
    `global_attn` (the reference fork's post-softmax injection), then, in
    train mode, dropped out; where the boolean `mask` is False the logits
    are -1e9, and `additive_mask` is added to them, clamped at -1e9
    (torch's float attn_mask, (L, L) or (B, H, L, L))."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, rel_pos_len: int = 0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim)) \
            if bias else None
        self.out_proj = _linear(dim, dim, bias=bias)
        self.pos_emb = RelPosEmb1D(rel_pos_len, dim // num_heads) \
            if rel_pos_len else None
        self.attn_drop = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.xavier_normal(self.in_proj_weight, generator)
        if self.in_proj_bias is not None:
            with torch.no_grad():
                self.in_proj_bias.zero_()
        _dense_init(self.out_proj, generator, init.xavier_normal)
        if self.pos_emb is not None:
            self.pos_emb.reset_parameters(generator)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        return x.view(b, n, self.num_heads,
                      d // self.num_heads).transpose(1, 2)

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                additive_mask: Optional[torch.Tensor] = None,
                alpha: Optional[torch.Tensor] = None,
                global_attn: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = query if key is None else key
        value = key if value is None else value
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = (self.in_proj_bias.chunk(3)
                         if self.in_proj_bias is not None else (None,) * 3)
        q = self._heads(F.linear(query, w_q, b_q))
        k = self._heads(F.linear(key, w_k, b_k))
        v = self._heads(F.linear(value, w_v, b_v))
        logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if self.pos_emb is not None:
            logits = logits + self.pos_emb(q)
        if mask is not None:
            logits = torch.where(mask, logits, -1e9)
        if additive_mask is not None:
            logits = logits + torch.clamp(additive_mask, min=-1e9)
        attn = torch.softmax(logits, dim=-1)
        applied = attn
        if alpha is not None:
            applied = applied * alpha
        if global_attn is not None:
            applied = applied + global_attn
        out = self.attn_drop(applied) @ v
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.out_proj(out), attn


class TransformerEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer semantics with the reference's
    pre-norm variant (agcn_tpu attention.py:166-224)."""

    def __init__(self, dim: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 pre_norm: bool = False, bias: bool = True,
                 attn_bias: bool = True, rel_pos_len: int = 0):
        super().__init__()
        self.pre_norm = pre_norm
        # any activation but 'relu' is flax's nn.gelu (tanh approximation)
        self.relu = activation == "relu"
        self.self_attn = MultiheadAttention(dim, num_heads, dropout,
                                            bias=attn_bias,
                                            rel_pos_len=rel_pos_len)
        self.norm1 = layer_norm(dim, bias)
        self.norm2 = layer_norm(dim, bias)
        self.linear1 = _linear(dim, dim_feedforward, bias)
        self.linear2 = _linear(dim_feedforward, dim, bias)
        self.drop_attn = Dropout(dropout)
        self.drop_ff = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.self_attn.reset_parameters(generator)
        _dense_init(self.linear1, generator)
        _dense_init(self.linear2, generator)

    def forward(self, x: torch.Tensor,
                additive_mask: Optional[torch.Tensor] = None,
                alpha: Optional[torch.Tensor] = None,
                global_attn: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.pre_norm:
            x = self.norm1(x)
        attn_out, attn = self.self_attn(x, additive_mask=additive_mask,
                                        alpha=alpha, global_attn=global_attn)
        x = x + self.drop_attn(attn_out)
        if not self.pre_norm:
            x = self.norm1(x)
        if self.pre_norm:
            x = self.norm2(x)
        y = self.linear1(x)
        # torch.relu, the one call tools/grad_parity.py's ReluProbe replays
        y = torch.relu(y) if self.relu else F.gelu(y, approximate="tanh")
        y = self.linear2(self.drop_ff(y))
        x = x + self.drop_out(y)
        if not self.pre_norm:
            x = self.norm2(x)
        return x, attn


class TransformerEncoder(nn.Module):
    """An optional position encoding ('abs' learned, 'cos' fixed, None),
    then `num_layers` layers named layer1 .. layerN; returns (tokens, the
    layers' attention weights)."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 activation: str = "relu", pre_norm: bool = False,
                 bias: bool = True, attn_bias: bool = True,
                 rel_pos_len: int = 0, pos_enc: Optional[str] = None,
                 max_len: int = 600):
        super().__init__()
        self.pos_enc = {"abs": PositionalEncoding,
                        "cos": CosSinPositionalEncoding}[pos_enc](
            max_len, dim) if pos_enc else None
        self.num_layers = num_layers
        for i in range(1, num_layers + 1):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                dim, num_heads, dim_feedforward, dropout, activation,
                pre_norm, bias=bias, attn_bias=attn_bias,
                rel_pos_len=rel_pos_len))

    def layers(self) -> List[TransformerEncoderLayer]:
        return [getattr(self, f"layer{i}")
                for i in range(1, self.num_layers + 1)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.pos_enc is not None:
            self.pos_enc.reset_parameters(generator)
        for layer in self.layers():
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if self.pos_enc is not None:
            x = self.pos_enc(x)
        attns = []
        for layer in self.layers():
            x, a = layer(x)
            attns.append(a)
        return x, attns


class CrossAttention(nn.Module):
    """Queries from one stream attend over another's tokens: bias-free
    `to_q` / `to_k` / `to_v` of num_heads x dim_head, then `to_out` back to
    the query's width (agcn_tpu attention.py:227-254)."""

    def __init__(self, dim: int, num_heads: int, dim_head: int = 64):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * dim_head
        self.to_q = _linear(dim, inner, bias=False)
        self.to_k = _linear(dim, inner, bias=False)
        self.to_v = _linear(dim, inner, bias=False)
        self.to_out = _linear(inner, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.to_q, self.to_k, self.to_v, self.to_out):
            _dense_init(layer, generator)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        return x.view(b, n, self.num_heads,
                      d // self.num_heads).transpose(1, 2)

    def forward(self, q_tokens: torch.Tensor,
                kv_tokens: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.to_q(q_tokens))
        k = self._heads(self.to_k(kv_tokens))
        v = self._heads(self.to_v(kv_tokens))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]),
                             dim=-1)
        out = attn @ v
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class CrossTransformer(nn.Module):
    """CrossViT-style fusion of two (B, 1 + L, D) streams with CLS at index
    0: each CLS token, layer-normed, attends over itself and the other
    stream's other tokens, and is added back (agcn_tpu
    attention.py:257-283). Only the CLS tokens change."""

    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 depth: int = 1):
        super().__init__()
        self.depth = depth
        for i in range(1, depth + 1):
            self.add_module(f"a_attends_b{i}",
                            CrossAttention(dim, num_heads, dim_head))
            self.add_module(f"norm_a{i}", layer_norm(dim))
            self.add_module(f"b_attends_a{i}",
                            CrossAttention(dim, num_heads, dim_head))
            self.add_module(f"norm_b{i}", layer_norm(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(1, self.depth + 1):
            getattr(self, f"a_attends_b{i}").reset_parameters(generator)
            getattr(self, f"b_attends_a{i}").reset_parameters(generator)

    def forward(self, a_tokens: torch.Tensor, b_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(1, self.depth + 1):
            a_cls, a_rest = a_tokens[:, :1], a_tokens[:, 1:]
            b_cls, b_rest = b_tokens[:, :1], b_tokens[:, 1:]
            a_cls = a_cls + getattr(self, f"a_attends_b{i}")(
                getattr(self, f"norm_a{i}")(a_cls),
                torch.cat([a_cls, b_rest], dim=1))
            b_cls = b_cls + getattr(self, f"b_attends_a{i}")(
                getattr(self, f"norm_b{i}")(b_cls),
                torch.cat([b_cls, a_rest], dim=1))
            a_tokens = torch.cat([a_cls, a_rest], dim=1)
            b_tokens = torch.cat([b_cls, b_rest], dim=1)
        return a_tokens, b_tokens


def _torch_linear_init(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch's default Linear init (JAX's torch_default_kernel and
    torch_default_bias): U(+-1/sqrt(fan_in)) for the kernel and the bias."""
    bound = init.torch_default(layer.in_features)
    bound(layer.weight, generator)
    if layer.bias is not None:
        bound(layer.bias, generator)


class ChannelNorm(nn.Module):
    """The reference's Normalize wrapper over (B, N, C) tokens
    (crossattention.py:37-43; agcn_tpu attention.py:287-304), the norm as
    its `fn`: 'bn' is BatchNorm1d over (B, C, N), per-channel statistics
    over every leading axis, which the channels-last `BatchNorm` computes
    as it stands; 'ln' is LayerNorm (flax's epsilon 1e-6)."""

    def __init__(self, dim: int, norm: str = "ln"):
        super().__init__()
        if norm not in ("bn", "ln"):
            raise ValueError(f"unknown norm {norm!r} (bn or ln)")
        self.fn = BatchNorm(dim) if norm == "bn" else layer_norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class _OutProj(nn.Module):
    """The attention's `to_out`: `linear`, then dropout."""

    def __init__(self, inner: int, output_dim: int, dropout: float):
        super().__init__()
        self.linear = _linear(inner, output_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.linear(x))


class LucidAttention(nn.Module):
    """lucidrains attention (reference crossattention.py:104-198; agcn_tpu
    attention.py:307-356): bias-free `to_q` / `to_k` / `to_v` of heads x
    dim_head from the `in_dim`-wide tokens, softmax(q k^T / sqrt(dim_head))
    v, `to_out` to `output_dim` and dropout. `residual`, a Linear, carries
    the input to the output's width where `dim` != `output_dim` or
    `res_proj` forces one (`res`). Returns (output, the softmax weights
    (B, H, N, N))."""

    def __init__(self, in_dim: int, dim: int, heads: int, dim_head: int,
                 output_dim: int, dropout: float = 0.0,
                 res_proj: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = _linear(in_dim, inner, bias=False)
        self.to_k = _linear(in_dim, inner, bias=False)
        self.to_v = _linear(in_dim, inner, bias=False)
        self.to_out = _OutProj(inner, output_dim, dropout)
        self.residual = (_linear(in_dim, output_dim)
                         if res_proj or dim != output_dim else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.to_q, self.to_k, self.to_v, self.to_out.linear,
                      self.residual):
            if layer is not None:
                _torch_linear_init(layer, generator)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.view(b, n, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        q, k, v = (self._heads(p(x)) for p in (self.to_q, self.to_k,
                                               self.to_v))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5,
                             dim=-1)
        out = attn @ v
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1)), attn

    def res(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.residual is None else self.residual(x)


class _FeedForwardNet(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.linear1 = _linear(dim, hidden_dim)
        self.linear2 = _linear(hidden_dim, out_dim)


class LucidFeedForward(nn.Module):
    """lucidrains FFN (crossattention.py:74-100; agcn_tpu
    attention.py:359-393): `net.linear1` -> act -> dropout ->
    `net.linear2` (to `output_dim`; 0 means `dim`) -> dropout, and a
    `residual` Linear where the widths differ. 'gelu' is the tanh
    approximation (flax nn.gelu); 'relu' calls torch.relu (the call
    tools/grad_parity.py's ReluProbe replays)."""

    def __init__(self, dim: int, hidden_dim: int, output_dim: int = 0,
                 dropout: float = 0.0, activation: str = "gelu"):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        out_dim = output_dim or dim
        self.out_dim = out_dim
        self.relu = activation == "relu"
        self.net = _FeedForwardNet(dim, hidden_dim, out_dim)
        self.drop_hidden = Dropout(dropout)
        self.drop_out = Dropout(dropout)
        self.residual = _linear(dim, out_dim) if dim != out_dim else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.net.linear1, self.net.linear2, self.residual):
            if layer is not None:
                _torch_linear_init(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.net.linear1(x)
        y = torch.relu(y) if self.relu else F.gelu(y, approximate="tanh")
        return self.drop_out(self.net.linear2(self.drop_hidden(y)))

    def res(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.residual is None else self.residual(x)


class _Normed(nn.Module):
    """The reference's PreNorm pairing: `norm` (a ChannelNorm) and `fn`
    (the attention or the FFN); the encoder decides where the norm goes."""

    def __init__(self, norm: ChannelNorm, fn: nn.Module):
        super().__init__()
        self.norm = norm
        self.fn = fn


class _LucidLayer(nn.Module):
    def __init__(self, attn: _Normed, ffn: _Normed):
        super().__init__()
        self.attn = attn
        self.ffn = ffn


class LucidTransformer(nn.Module):
    """The reference's CrossViT-derived encoder (crossattention.py:202-304;
    agcn_tpu attention.py:396-486) of SGN v15: per-layer widths, the
    attention's output width (`out_dims`, d_out) apart from the FFN's
    (`mlp_out_dims`, 0: the attention's), pre- or post-norm with BN or LN
    channel norms, and an optional global norm. Pre-norm, a layer is

        x = attn(norm(x)) + attn.res(x);  x = ffn(norm(x)) + ffn.res(x)

    and post-norm x = norm(attn(x)) + attn.res(x); x = norm(ffn(x)) +
    ffn.res(x). Returns (tokens, each layer's attention weights)."""

    def __init__(self, in_dim: int, depth: int, dims: Sequence[int],
                 heads: Sequence[int], dim_heads: Sequence[int],
                 mlp_dims: Sequence[int], mlp_out_dims: Sequence[int],
                 out_dims: Sequence[int], dropouts: Sequence[float],
                 activation: str = "gelu", norm: str = "ln",
                 global_norm: bool = True, post_norm: bool = False,
                 res_proj: bool = False):
        super().__init__()
        self.depth = depth
        self.post_norm = post_norm
        self.layers = nn.Module()
        width = in_dim
        for i in range(depth):
            attn = LucidAttention(width, dims[i], heads[i], dim_heads[i],
                                  out_dims[i], dropouts[i], res_proj)
            ffn = LucidFeedForward(out_dims[i], mlp_dims[i], mlp_out_dims[i],
                                   dropouts[i], activation)
            attn_norm = out_dims[i] if post_norm else width
            ffn_norm = ffn.out_dim if post_norm else out_dims[i]
            self.layers.add_module(f"l{i + 1}", _LucidLayer(
                _Normed(ChannelNorm(attn_norm, norm), attn),
                _Normed(ChannelNorm(ffn_norm, norm), ffn)))
            width = ffn.out_dim
        self.out_dim = width
        self.norm = ChannelNorm(width, norm) if global_norm else None

    @staticmethod
    def from_mha_kwargs(kwargs: dict, in_dim: int) -> "LucidTransformer":
        """Build from the reference's *_mha_kwargs (sgn_v15.py:444-457):
        d_model / nhead / d_head / dim_feedforward /
        dim_feedforward_output as per-layer lists (a scalar for every
        layer), d_out defaulting to d_model (crossattention.py:240)."""
        depth = kwargs["num_layers"]

        def as_list(key, default=None):
            v = kwargs.get(key, default)
            return [v] * depth if isinstance(v, (int, float)) else list(v)

        return LucidTransformer(
            in_dim, depth, dims=as_list("d_model"), heads=as_list("nhead"),
            dim_heads=as_list("d_head"),
            mlp_dims=as_list("dim_feedforward"),
            mlp_out_dims=as_list("dim_feedforward_output", 0),
            out_dims=as_list("d_out", kwargs["d_model"]),
            dropouts=as_list("dropout", 0.0),
            activation=kwargs.get("activation", "gelu"),
            norm=kwargs.get("norm", "ln"),
            global_norm=kwargs.get("global_norm", True),
            post_norm=kwargs.get("post_norm", False),
            res_proj=kwargs.get("res_proj", False))

    def blocks(self) -> List[_LucidLayer]:
        return [getattr(self.layers, f"l{i}")
                for i in range(1, self.depth + 1)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.blocks():
            layer.attn.fn.reset_parameters(generator)
            layer.ffn.fn.reset_parameters(generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        attns = []
        for layer in self.blocks():
            attn, ffn = layer.attn, layer.ffn
            if self.post_norm:
                y, a = attn.fn(x)
                x = attn.norm(y) + attn.fn.res(x)
                x = ffn.norm(ffn.fn(x)) + ffn.fn.res(x)
            else:
                y, a = attn.fn(attn.norm(x))
                x = y + attn.fn.res(x)
                x = ffn.fn(ffn.norm(x)) + ffn.fn.res(x)
            attns.append(a)
        if self.norm is not None:
            x = self.norm(x)
        return x, attns
