"""Classification losses over logits and int labels, the InfoGCN MMD loss
and the cosine feature-similarity loss of the SGN recipes (port of
agcn_tpu/train/losses.py:18-140; reference utils/loss.py)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


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


def mmd_loss(z: torch.Tensor, z_prior: torch.Tensor, labels: torch.Tensor,
             num_class: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The InfoGCN MMD loss (reference utils/loss.py:90-106; agcn_tpu
    losses.py:61-79): (mmd, l2_z_mean), the mean squared distance of the
    latent's class means from the class priors over the classes present
    in the batch, and the L2 norm of the batch's mean latent."""
    onehot = F.one_hot(labels, num_class).to(z.dtype)  # (B, K)
    counts = onehot.sum(dim=0)
    means = (onehot.T @ z) / torch.clamp(counts[:, None], min=1.0)
    present = (counts > 0).to(z.dtype)
    sq = ((means - z_prior) ** 2).sum(dim=-1)
    denom = torch.clamp(present.sum() * z.shape[-1], min=1.0)
    return (sq * present).sum() / denom, torch.linalg.vector_norm(
        z.mean(dim=0))


def _pairwise(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean cosine and the mean distance over the distinct pairs of
    `rows` (reference get_vector_property, processor.py:43-53)."""
    normed = rows / torch.clamp(torch.linalg.vector_norm(
        rows, dim=-1, keepdim=True), min=1e-9)
    off = 1.0 - torch.eye(rows.shape[0], dtype=rows.dtype,
                          device=rows.device)
    denom = torch.clamp(off.sum(), min=1.0)
    dist = torch.linalg.vector_norm(rows[:, None] - rows[None], dim=-1)
    return ((normed @ normed.T) * off).sum() / denom, \
        (dist * off).sum() / denom


@torch.no_grad()
def latent_diagnostics(z: torch.Tensor, z_prior: torch.Tensor,
                       labels: torch.Tensor, num_class: int
                       ) -> Dict[str, torch.Tensor]:
    """The MMD loss's metrics beside it (agcn_tpu trainer.py:420-446):
    `cos_z` and `dist_z` over the latent's class means (an absent class's
    mean is zero), `cos_z_prior` and `dist_z_prior` over the priors."""
    onehot = F.one_hot(labels, num_class).to(z.dtype)
    means = (onehot.T @ z) / torch.clamp(onehot.sum(dim=0), min=1.0)[:, None]
    cos_z, dist_z = _pairwise(means)
    cos_p, dist_p = _pairwise(z_prior)
    return {"cos_z": cos_z, "dist_z": dist_z, "cos_z_prior": cos_p,
            "dist_z_prior": dist_p}


def cosine_loss(x1: torch.Tensor, x2: torch.Tensor, mode: int = 1,
                eps: float = 1e-8) -> torch.Tensor:
    """Feature-similarity loss 1 - mean(cos) (reference utils/loss.py:7-21;
    agcn_tpu losses.py:82-99). Mode 1: the cosine over axis 1 (channels
    of an (N, C, T) output); mode 2: the cosine of the L2-norm vectors
    along axis 1."""
    if mode == 2:
        x1 = torch.linalg.vector_norm(x1, dim=1)
        x2 = torch.linalg.vector_norm(x2, dim=1)
        dim = -1
    else:
        dim = 1
    num = (x1 * x2).sum(dim=dim)
    den = torch.clamp(torch.linalg.vector_norm(x1, dim=dim)
                      * torch.linalg.vector_norm(x2, dim=dim), min=eps)
    return 1.0 - (num / den).mean()


def fsim_pair_loss(branch_outputs: Sequence[Optional[torch.Tensor]],
                   alphas: Sequence[float], kernels: int,
                   mode: int = 1) -> Union[torch.Tensor, float]:
    """The cosine feature-similarity loss with the reference's pairing
    (utils/processor.py:583-599; agcn_tpu losses.py:102-126): the level-i
    kernel-j temporal branch output is pulled toward the last level's
    kernel-j output, weighted by alphas[i * kernels + j] (the last alpha
    for pairs beyond the list). `kernels` is len(multi_t[-1]), the
    branches a level; None outputs are dropped."""
    outs = [o for o in branch_outputs if o is not None]
    kernels = max(int(kernels), 1)
    alphas = list(alphas) or [1.0]
    total = 0.0
    for i in range(len(outs) // kernels - 1):
        for j in range(kernels):
            idx = i * kernels + j
            a = alphas[idx] if idx < len(alphas) else alphas[-1]
            total = total + a * cosine_loss(outs[idx], outs[-kernels + j],
                                            mode=mode)
    return total


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
