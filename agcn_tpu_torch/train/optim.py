"""The optimizer and LR schedule of the AGCN recipes
(port of agcn_tpu/train/optim.py:18-38, 77-89; reference
utils/processor.py:349-403, 698).

`SGDNesterov` is the optax chain clip_by_global_norm -> add_decayed_weights
-> sgd(momentum, nesterov) with the learning rate taken from the schedule
at the update count *before* the update, as optax's count is. The clip
is optax's: g * max_norm / ||g|| when ||g|| >= max_norm, ||g|| the global
norm over every parameter (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to
the norm and is another function). The decay and momentum steps are
`torch.optim.SGD`'s, whose weight decay and nesterov trace match optax's
for every parameter (BN affines and PA included).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

Schedule = Callable[[int], float]

_LEFTOVER = "waits in ROADMAP Queue 1: training leftovers"


def warmup_step_schedule(base_lr: float, steps_per_epoch: int,
                         decay_epochs: Sequence[int],
                         warm_up_epoch: int = 0,
                         gamma: float = 0.1) -> Schedule:
    """Per-epoch warmup, then multiplicative step decay.

    lr(e) = base * (e+1) / warmup                  e < warmup
          = base * gamma^(#decay_epochs <= e)      otherwise
    with e = count // steps_per_epoch.
    """
    decay = sorted(int(d) for d in decay_epochs)

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        if epoch < warm_up_epoch:
            return base_lr * (epoch + 1) / max(warm_up_epoch, 1)
        return base_lr * gamma ** sum(epoch >= d for d in decay)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every g becomes
    (g / ||g||) * max_norm when the global norm ||g|| >= max_norm. The
    choice is made on the device (no host sync)."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum()
    norm = norm.sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class SGDNesterov:
    """clip -> L2 weight decay -> SGD with (nesterov) momentum, the
    learning rate from `schedule(count)`."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Schedule, weight_decay: float = 1e-4,
                 momentum: float = 0.9, nesterov: bool = True,
                 grad_clip: Optional[float] = 1.0):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.sgd = torch.optim.SGD(self.params, lr=schedule(0),
                                   momentum=momentum, nesterov=nesterov,
                                   weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("every parameter needs a gradient (zero it, "
                               "as the PA freeze does, rather than drop it)")
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)
        lr = self.lr()
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.sgd.load_state_dict(state["sgd"])


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    schedule: Schedule, weight_decay: float = 1e-4,
                    nesterov: bool = True,
                    grad_clip: Optional[float] = 1.0) -> SGDNesterov:
    """Optimizer factory (reference load_optimizer, processor.py:395-430);
    the port has the SGD chain of the AGCN recipes ('sgd-llrd' is the
    same chain; its per-layer scaling is the trainer's `llrd_factor`)."""
    key = name.lower()
    if key in ("sgd", "sgd-llrd"):
        return SGDNesterov(params, schedule, weight_decay,
                           nesterov=nesterov, grad_clip=grad_clip)
    if key in ("adam", "adamw", "adamw-llrd") or key.startswith("sam"):
        raise NotImplementedError(f"optimizer {name!r} {_LEFTOVER}")
    raise ValueError(f"Unknown optimizer {name!r}")


def build_schedule(scheduler: str, base_lr: float, steps_per_epoch: int,
                   decay_epochs: Sequence[int],
                   warm_up_epoch: int = 0) -> Schedule:
    """The LR schedule of a recipe: every scheduler but the cyclic ones is
    the warmup + step decay of the AGCN recipes (agcn_tpu
    trainer.py:288-300)."""
    if scheduler in ("onecyclelr", "cycliclr", "cycliclrtri2"):
        raise NotImplementedError(f"scheduler {scheduler!r} {_LEFTOVER}")
    return warmup_step_schedule(base_lr, steps_per_epoch, decay_epochs,
                                warm_up_epoch)
