"""Parameter initializers of the reference (port of agcn_tpu/ops/initializers.py).

Each initializer fills a tensor in place from an explicit
`torch.Generator` and returns it. Layouts are torch's: conv kernels
(out, in, kh, kw), linear kernels (out, in). The draws cannot match the
JAX package's value for value (another random generator); the tests hold
their statistics instead.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Init = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def _normal(tensor: torch.Tensor, std: float,
            generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return tensor.normal_(0.0, std, generator=generator)


def kaiming_normal_fan_out(tensor: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """He normal, fan_out mode (reference agcn.py:26-28 conv_init):
    std = sqrt(2 / (out * kh * kw))."""
    receptive = math.prod(tensor.shape[2:])
    return _normal(tensor, math.sqrt(2.0 / (tensor.shape[0] * receptive)),
                   generator)


def kaiming_normal_fan_in(tensor: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """He normal, fan_in mode (reference aagcn.py:104, the channel
    attention's fc1c): std = sqrt(2 / (in * receptive))."""
    receptive = math.prod(tensor.shape[2:])
    return _normal(tensor, math.sqrt(2.0 / (tensor.shape[1] * receptive)),
                   generator)


def xavier_normal(tensor: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Glorot normal (reference aagcn.py:68, the spatial attention's conv):
    std = sqrt(2 / ((in + out) * receptive))."""
    receptive = math.prod(tensor.shape[2:])
    fans = (tensor.shape[0] + tensor.shape[1]) * receptive
    return _normal(tensor, math.sqrt(2.0 / fans), generator)


def conv_branch_init(branches: int) -> Init:
    """Branch-scaled normal for the subset output projections:
    std = sqrt(2 / (out * in * kh * branches)) (reference agcn.py:17-23)."""

    def init(tensor: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        out, cin = tensor.shape[:2]
        kh = tensor.shape[2] if tensor.dim() > 2 else 1
        return _normal(tensor, math.sqrt(2.0 / (out * cin * kh * branches)),
                       generator)

    return init


def fc_init(num_class: int) -> Init:
    """Classifier init: normal(0, sqrt(2/num_class)) (reference
    agcn.py:157)."""

    def init(tensor: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        return _normal(tensor, math.sqrt(2.0 / num_class), generator)

    return init


def normal(std: float) -> Init:
    """normal(0, std) (flax `nn.initializers.normal`: the transformer's CLS
    tokens and learned position tables take std 0.02)."""

    def init(tensor: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        return _normal(tensor, std, generator)

    return init


def lecun_normal(tensor: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dense`'s default kernel init, lecun_normal: a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in
    (std = sqrt(1 / fan_in) / 0.8796..., the std of a unit normal
    truncated so). Linear layout (out, in): fan_in = in."""
    receptive = math.prod(tensor.shape[2:])
    std = math.sqrt(1.0 / (tensor.shape[1] * receptive)) \
        / .87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)


def torch_default(fan_in: int) -> Init:
    """PyTorch's default Conv/Linear bias init, and its default kernel init
    (kaiming_uniform(a=sqrt(5)) reduces to it): U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (agcn_tpu/ops/initializers.py:68-85)."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(tensor: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            return tensor.uniform_(-bound, bound, generator=generator)

    return init


def constant(value: float) -> Init:
    def init(tensor: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        del generator
        with torch.no_grad():
            return tensor.fill_(value)

    return init
