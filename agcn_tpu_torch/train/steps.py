"""Train and eval steps (port of agcn_tpu/train/steps.py:59-171;
reference utils/processor.py:604-778).

One train step is: forward in train mode (the BN running statistics come
from this forward; dropout masks from the model's generator reseeded for
the update count), loss (plus `aux_loss_fn` of the model's aux outputs),
backward, the optional `grad_transform`, then the optimizer's update
(clip, then its chain). A parameter the forward did not use (SGN's G
`alpha` without a prior G) takes a zero gradient, as `jax.grad` gives it.
Its metrics are the loss and the accuracy of the same logits (and the aux
loss's), returned as device tensors: the caller decides when to wait for
them.

With `sam_rho` > 0 the step is SAM's two passes (agcn_tpu steps.py:86-99;
reference processor.py:673-687): pass one gives the loss, the logits,
the metrics and the BN running statistics; the parameters are perturbed
by `optim.sam_perturbation` of pass one's gradients; pass two, with the
same dropout masks and the running statistics left alone
(`ops.norm.recomputing`), gives the gradients the update takes; the
parameters come back before `grad_transform` and the update.

In a data-parallel run the forward and backward go through the
trainer's DistributedDataParallel wrapper (`forward`), so the gradients
the update (and SAM's perturbation) takes are those of the global batch,
as JAX's are; the clip then sees the global gradient.

JAX's `lax.scan` of K steps (:111-139) is the trainer's epoch loop
here: K batches in one copy, their steps back to back. The eval step
averages the logits, and the aux `z`, of each sample's crops (multi-crop
eval, the SGN recipes' `multi_test`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agcn_tpu_torch.ops.norm import recomputing
from agcn_tpu_torch.train.optim import ClippedOptimizer, sam_perturbation

Metrics = Dict[str, torch.Tensor]
AuxLoss = Callable[[Optional[Dict[str, Any]], torch.Tensor],
                   Tuple[Any, Metrics]]


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
    step s draws the masks of the run that was not interrupted. A data
    rank d > 0 (`dropout_shard`, set by the trainer) folds d in too, so
    data ranks draw their own masks on their own rows while the edge
    ranks of one data rank draw the same."""
    generator = getattr(model, "dropout_generator", None)
    if generator is not None:
        shard = getattr(model, "dropout_shard", 0)
        seed = np.random.SeedSequence(
            [model.dropout_seed, step] + ([shard] if shard else []))
        generator.manual_seed(int(seed.generate_state(1, np.uint64)[0]))


def _forward(model: nn.Module, x: torch.Tensor, aux: bool,
             has_aux: Optional[bool] = None):
    """(logits, the model's aux outputs or None); a model without aux
    outputs (no `has_aux`) gives None, as JAX's models do, and one that
    returns (logits, G) (the original SGN) gives its logits."""
    if has_aux is None:
        has_aux = getattr(model, "has_aux", False)
    if aux and has_aux:
        return model(x, return_aux=True)
    out = model(x)
    return (out[0] if isinstance(out, tuple) else out), None


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: ClippedOptimizer,
                    grad_transform: Optional[Callable[[nn.Module],
                                                      None]] = None,
                    sam_rho: float = 0.0,
                    aux_loss_fn: Optional[AuxLoss] = None,
                    forward: Optional[nn.Module] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """A step (x, y) -> {"loss", "acc", aux metrics} that updates `model`
    in place. With `aux_loss_fn` a model that has aux outputs is called
    with `return_aux=True` and the loss is loss_fn + aux_loss_fn(aux,
    y)[0]. `forward` (a DistributedDataParallel wrapper of `model`) runs
    the forward when given."""
    params = [p for p in model.parameters() if p.requires_grad]
    run = model if forward is None else forward

    def loss_and_grads(x, y):
        seed_dropout(model, optimizer.count)
        logits, aux = _forward(run, x, aux_loss_fn is not None,
                               getattr(model, "has_aux", False))
        loss = loss_fn(logits, y)
        metrics: Metrics = {}
        if aux_loss_fn is not None:
            extra, metrics = aux_loss_fn(aux, y)
            loss = loss + extra
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss, logits, metrics

    def train_step(x: torch.Tensor, y: torch.Tensor) -> Metrics:
        model.train()
        optimizer.zero_grad()
        loss, logits, metrics = loss_and_grads(x, y)
        if sam_rho > 0.0:
            with torch.no_grad():
                perturbed = sam_perturbation(params,
                                             [p.grad for p in params],
                                             sam_rho)
                kept = [p.detach().clone() for p in params]
                torch._foreach_copy_(params, perturbed)
            del perturbed
            optimizer.zero_grad()
            with recomputing(model):
                loss_and_grads(x, y)
            with torch.no_grad():
                torch._foreach_copy_(params, kept)
        if grad_transform is not None:
            grad_transform(model)
        optimizer.step()
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "acc": acc,
                **{k: torch.as_tensor(v).detach() for k, v in
                   metrics.items()}}

    return train_step


def make_eval_step(model: nn.Module, loss_fn: Optional[Callable] = None,
                   multi_crop: int = 1,
                   aux_loss_fn: Optional[AuxLoss] = None):
    """A step (x, y=None) -> (logits, metrics) in eval mode. With
    `multi_crop` n > 1 the rows of x are each sample's n crops, one after
    another: the logits are averaged over them before the loss and the
    accuracy, one row per sample, and y holds one label per sample
    (agcn_tpu/train/steps.py:140-171; reference processor.py:546-548).
    With `aux_loss_fn` (and y) the loss adds it over the model's aux
    outputs, whose `z` is averaged over the crops and whose
    `branch_outputs` keep one row a crop (reference processor.py:563-567);
    the metrics add its own."""

    def eval_step(x: torch.Tensor, y: Optional[torch.Tensor] = None):
        model.eval()
        with torch.inference_mode():
            logits, aux = _forward(model, x, aux_loss_fn is not None)
            if multi_crop > 1:
                logits = logits.reshape(-1, multi_crop,
                                        logits.shape[-1]).mean(dim=1)
                if aux is not None and "z" in aux:
                    z = aux["z"]
                    aux = dict(aux, z=z.reshape(-1, multi_crop,
                                                z.shape[-1]).mean(dim=1))
            metrics: Metrics = {}
            if loss_fn is not None and y is not None:
                metrics["loss"] = loss_fn(logits, y)
                metrics["acc"] = (logits.argmax(-1) == y).float().mean()
                if aux_loss_fn is not None:
                    extra, extra_metrics = aux_loss_fn(aux, y)
                    metrics["loss"] = metrics["loss"] + extra
                    metrics.update(extra_metrics)
        return logits, metrics

    return eval_step
