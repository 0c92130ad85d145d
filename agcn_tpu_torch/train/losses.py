"""Classification losses over logits and int labels
(port of agcn_tpu/train/losses.py:18-58, 129-140; reference
utils/loss.py). The MMD, cosine and feature-similarity losses of the SGN
recipes wait for SGN (ROADMAP Queue 1: SGN family)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy (reference nn.CrossEntropyLoss)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def _smoothed_target(logp: torch.Tensor, labels: torch.Tensor, off: float,
                     on: float) -> torch.Tensor:
    target = torch.full_like(logp, off)
    return target.scatter(-1, labels[:, None], on)


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.1) -> torch.Tensor:
    """SGN-style label smoothing (reference utils/loss.py:25-39):
    off-target mass smoothing/(C-1), target 1-smoothing (not torch's
    F.cross_entropy(label_smoothing=...) convention)."""
    logp = torch.log_softmax(logits, dim=-1)
    target = _smoothed_target(logp, labels,
                              smoothing / (logits.shape[-1] - 1),
                              1.0 - smoothing)
    return (-target * logp).sum(-1).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               smoothing: float = 0.0,
               alpha: Optional[torch.Tensor] = None,
               gamma: float = 2.0) -> torch.Tensor:
    """Categorical focal loss with smoothing and per-class alpha weights
    (reference utils/loss.py:45-86)."""
    eps = smoothing / logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    target = _smoothed_target(logp, labels, eps, 1.0 - smoothing + eps)
    ce = (-target * logp).sum(-1)
    if alpha is not None:
        ce = ce * alpha.to(ce.device)[labels]
    pt = torch.softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    return ((1.0 - pt) ** gamma * ce).mean()


def build_loss(name: str, num_class: int, smoothing: float = 0.0,
               alpha: Optional[Sequence[float]] = None,
               gamma: float = 2.0) -> Callable:
    """Loss factory mirroring the reference's get_loss
    (utils/processor.py:298-327)."""
    if name in ("ce", "crossentropy"):
        if smoothing > 0.0:
            return lambda lg, lb: label_smoothing_loss(lg, lb, smoothing)
        return cross_entropy
    if name == "focal":
        a = None if not alpha else torch.as_tensor(alpha, dtype=torch.float32)
        return lambda lg, lb: focal_loss(lg, lb, smoothing, a, gamma)
    raise ValueError(f"unknown loss {name!r}")
