"""Train and eval steps (port of agcn_tpu/train/steps.py:59-108, 142-171;
reference utils/processor.py:604-778).

One train step is: forward in train mode (the BN running statistics come
from this forward; dropout masks from the model's generator reseeded for
the update count), loss, backward, the optional `grad_transform`, then
the optimizer's update (clip, then its chain). A parameter the forward
did not use (SGN's G `alpha` without a prior G) takes a zero gradient, as
`jax.grad` gives it. Its metrics are the loss and the accuracy of the
same logits, returned as device tensors: the caller decides when to wait
for them. The eval step averages the logits of each sample's crops
(multi-crop eval, the SGN recipes' `multi_test`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from agcn_tpu_torch.train.optim import ClippedOptimizer

Metrics = Dict[str, torch.Tensor]
_LEFTOVER = "waits in ROADMAP Queue 1: training leftovers"


def zero_grads_by_name(model: nn.Module, substr: str) -> None:
    """Zero every gradient whose parameter name contains `substr`: the PA
    freeze of `only_train_part` (agcn_tpu trainer.py:35-47; reference
    processor.py:612-616). The zeroed parameters still take weight decay
    and momentum, as in the optax chain."""
    for name, p in model.named_parameters():
        if substr in name and p.grad is not None:
            p.grad.zero_()


def freeze_pa(model: nn.Module) -> None:
    zero_grads_by_name(model, "PA")


def seed_dropout(model: nn.Module, step: int) -> None:
    """Reseed the model's dropout generator, where it has one, from its
    `dropout_seed` and the update count, as the JAX step draws its masks
    from fold_in(rng, step) (agcn_tpu/train/steps.py:87): a run resumed at
    step s draws the masks of the run that was not interrupted."""
    generator = getattr(model, "dropout_generator", None)
    if generator is not None:
        seed = np.random.SeedSequence([model.dropout_seed, step])
        generator.manual_seed(int(seed.generate_state(1, np.uint64)[0]))


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: ClippedOptimizer,
                    grad_transform: Optional[Callable[[nn.Module],
                                                      None]] = None,
                    sam_rho: float = 0.0,
                    aux_loss_fn: Optional[Callable] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """A step (x, y) -> {"loss", "acc"} that updates `model` in place."""
    if sam_rho > 0.0:
        raise NotImplementedError(f"SAM (sam_rho > 0) {_LEFTOVER}")
    if aux_loss_fn is not None:
        raise NotImplementedError(
            "auxiliary losses (MMD, feature similarity) wait in ROADMAP "
            "Queue 1 item 7: SGN family")

    def train_step(x: torch.Tensor, y: torch.Tensor) -> Metrics:
        model.train()
        optimizer.zero_grad()
        seed_dropout(model, optimizer.count)
        logits = model(x)
        loss = loss_fn(logits, y)
        loss.backward()
        for p in model.parameters():
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        if grad_transform is not None:
            grad_transform(model)
        optimizer.step()
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return train_step


def make_eval_step(model: nn.Module, loss_fn: Optional[Callable] = None,
                   multi_crop: int = 1):
    """A step (x, y=None) -> (logits, metrics) in eval mode. With
    `multi_crop` n > 1 the rows of x are each sample's n crops, one after
    another: the logits are averaged over them before the loss and the
    accuracy, one row per sample, and y holds one label per sample
    (agcn_tpu/train/steps.py:140-171; reference processor.py:546-548)."""

    def eval_step(x: torch.Tensor, y: Optional[torch.Tensor] = None):
        model.eval()
        with torch.inference_mode():
            logits = model(x)
            if multi_crop > 1:
                logits = logits.reshape(-1, multi_crop,
                                        logits.shape[-1]).mean(dim=1)
            metrics: Metrics = {}
            if loss_fn is not None and y is not None:
                metrics["loss"] = loss_fn(logits, y)
                metrics["acc"] = (logits.argmax(-1) == y).float().mean()
        return logits, metrics

    return eval_step
