"""Optimizers and LR schedules of the recipes
(port of agcn_tpu/train/optim.py:18-178; reference
utils/processor.py:349-473, 698).

Each optimizer is an optax chain of the JAX package, run as clip ->
a `torch.optim` step, with the learning rate taken from the schedule at
the update count *before* the update, as optax's count is:

- `SGDNesterov`: clip_by_global_norm -> add_decayed_weights ->
  sgd(momentum, nesterov): `torch.optim.SGD`, whose weight decay and
  nesterov trace match optax's for every parameter;
- Adam: clip -> add_decayed_weights (L2 on the gradient) ->
  scale_by_adam -> scale_by_learning_rate;
- AdamW: clip -> optax.adamw (scale_by_adam -> add_decayed_weights
  (decoupled) -> scale_by_learning_rate).

Both Adams run `OptaxAdam`, optax's elementwise fp32 formulas in its
order: its bias corrections 1 - b**count are computed in fp32, as optax
computes them, where torch.optim.Adam takes them in double (1e-5 apart
at b2 = 0.999 after a few steps, which moves the parameters by several
fp32 ulps in ten).

The clip is optax's: g * max_norm / ||g|| when ||g|| >= max_norm, ||g||
the global norm over every parameter (`torch.nn.utils.clip_grad_norm_`
adds 1e-6 to the norm and is another function).

Layer-wise LR decay (`with_llrd`, :136-178) multiplies each parameter's
update by its `llrd_scales` factor; every optimizer here is linear in the
learning rate, so the port gives each factor a parameter group whose
rate is the schedule's times the factor. The schedules are plain
functions of the count (Python floats), copied formula for formula,
boundaries included. `from_config` wires a config's schedule, chain and
LLRD rule, for the trainer and for anything that builds its step.

SAM (`optimizer: SAM*`) is SGD nesterov here, as in `build_optimizer`
(agcn_tpu optim.py:117-124); its two passes live in the train step
(`train/steps.py`), which perturbs the parameters by `sam_perturbation`.
"""

from __future__ import annotations

import math
import re
from typing import (Callable, Dict, Iterable, List, Optional, Sequence)

import numpy as np
import torch

Schedule = Callable[[int], float]


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


def _piecewise_cosine(init_value: float,
                      boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_interpolate_schedule('cosine', ...): between
    boundaries, a half cosine from each accumulated value to the next;
    past the last, its value. In optax's precision: the values and their
    half differences in double, the rest in fp32 (near a small value the
    fp32 sum loses digits, ~1e-5 of it, which the port keeps)."""
    boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = (0,) + boundaries
    values = list(np.cumprod((init_value,) + scales))
    if any(b == a for a, b in zip(bounds, bounds[1:])):
        # optax divides by the interval's size: 0 / 0 is NaN at every count
        raise ValueError(
            f"onecycle schedule with an empty interval (boundaries "
            f"{bounds}): optax's is NaN at every step; give the warm-up "
            "at least one step")
    f32 = np.float32

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return float(f32(values[-1]))
        i = max(j for j in range(len(bounds) - 1) if bounds[j] <= count)
        pct = f32(count - bounds[i]) / f32(bounds[i + 1] - bounds[i])
        half = f32((values[i] - values[i + 1]) / 2.0)
        # cos of the fp32 angle, rounded to fp32 (XLA's fp32 cos is
        # nearer that than numpy's)
        cos = f32(math.cos(f32(math.pi) * pct))
        return float(f32(values[i + 1]) + half * (cos + f32(1)))

    return schedule


def onecycle_schedule(base_lr: float, steps_per_epoch: int, num_epoch: int,
                      warm_up_epoch: int = 0,
                      initial_lr: Optional[float] = None,
                      final_lr: Optional[float] = None) -> Schedule:
    """OneCycle as optax.cosine_onecycle_schedule (agcn_tpu optim.py:41-54;
    torch's OneCycleLR is another function): from base / div up to base
    by the step int(pct_start * total), then down to
    base / (div * final_div_factor) at `total`; pct_start =
    max(warm_up_epoch / num_epoch, 1e-3). The JAX package ignores
    anneal_strategy, and so does the port."""
    total = steps_per_epoch * num_epoch
    if total <= 0:
        raise ValueError("onecycle schedule with no step")
    pct_start = max(warm_up_epoch / max(num_epoch, 1), 1e-3)
    div = base_lr / (initial_lr if initial_lr else base_lr / 25)
    final_div = base_lr / (final_lr if final_lr else base_lr / 1e4)
    final_div_factor = final_div / div
    # a dict literal, as optax's: equal boundaries keep the second scale
    return _piecewise_cosine(base_lr / div, {
        int(pct_start * total): div,
        int(total): 1.0 / (div * final_div_factor)})


def cyclic_schedule(base_lr: float, steps_per_epoch: int,
                    mode: str = "triangular") -> Schedule:
    """CyclicLR triangular / triangular2 (agcn_tpu optim.py:57-74): one
    cycle an epoch, up from base / 100 over the first half, down over the
    second; triangular2 halves the amplitude every cycle."""
    up = max(steps_per_epoch // 2, 1)
    down = max(steps_per_epoch - up, 1)
    lo, hi = base_lr * 1e-2, base_lr

    def schedule(count: int) -> float:
        cycle, pos = divmod(count, up + down)
        frac = pos / up if pos < up else 1.0 - (pos - up) / down
        amp = hi - lo
        if mode == "triangular2":
            amp = amp * 0.5 ** cycle
        return lo + amp * frac

    return schedule


def llrd_scales(names: Sequence[str], factor: float) -> List[float]:
    """Per-parameter LR multipliers of layer-wise LR decay (agcn_tpu
    optim.py:136-161): a parameter whose name holds `layer<N>` belongs to
    layer N (the same N in every encoder shares one multiplier); the
    deepest layer keeps the base LR, each shallower one `factor` once
    more; every other parameter keeps the base LR."""
    ids = [re.search(r"layer(\d+)", n) for n in names]
    ids = [int(m.group(1)) if m else None for m in ids]
    rank = {i: r for r, i in enumerate(sorted(
        {i for i in ids if i is not None}, reverse=True))}
    return [1.0 if i is None else factor ** rank[i] for i in ids]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm over every element of `tensors`, in
    fp32, as a device scalar."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum() \
        .sqrt()


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every g becomes
    (g / ||g||) * max_norm when the global norm ||g|| >= max_norm. The
    choice is made on the device (no host sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


@torch.no_grad()
def sam_perturbation(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], rho: float = 0.05
                     ) -> List[torch.Tensor]:
    """SAM's first step (agcn_tpu optim.py:180-185; davda54/sam, which
    the reference calls at processor.py:673-687): p + g * rho / (||g|| +
    1e-12), ||g|| the global norm over every gradient, no clipping.
    Returns the perturbed values; `params` are not touched."""
    scale = rho / (global_norm(grads) + 1e-12)
    return [p + g * scale.to(g.dtype) for p, g in zip(params, grads)]


def _bias_correction(decay: float, count: int) -> float:
    """optax's 1 - decay**count, in fp32."""
    power = torch.pow(torch.tensor(decay, dtype=torch.float32),
                      torch.tensor(float(count)))
    return float(1 - power)


# optax.scale_by_adam's defaults, which agcn_tpu's adam and adamw take
B1, B2 = 0.9, 0.999


class OptaxAdam(torch.optim.Optimizer):
    """optax.scale_by_adam (B1, B2, eps, eps_root 0) with its weight decay
    and learning rate: `decoupled=False` is agcn_tpu's `adam` (g + wd * p
    before the moments), `decoupled=True` optax.adamw (adam + wd * p after
    them); the update is then -lr times it. State per parameter: `step`,
    the moments `mu` and `nu`."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 eps: float = 1e-8, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      eps=eps, decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            wd = group["weight_decay"]
            states = [self.state[p] for p in ps]
            for p, st in zip(ps, states):
                if not st:
                    st.update(step=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
            count = states[0]["step"] + 1
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            gs = [p.grad for p in ps]
            if wd and not group["decoupled"]:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, B1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - B1))
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(sq, 1 - B2)
            torch._foreach_mul_(nus, B2)
            torch._foreach_add_(nus, sq)
            # mu_hat / (sqrt(nu_hat) + eps)
            den = torch._foreach_div(nus, _bias_correction(B2, count))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mus, _bias_correction(B1, count))
            torch._foreach_div_(upd, den)
            if wd and group["decoupled"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, wd))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(ps, upd)
            for st in states:
                st["step"] = count


class ClippedOptimizer:
    """clip -> a `torch.optim` optimizer made by `make(groups, lr)`, every
    parameter group's rate the schedule's at the current count times that
    group's LLRD multiplier.

    `lr_scales`: one multiplier per parameter (`llrd_scales`), or None;
    parameters with equal multipliers share a group. The state (`count`
    and the torch optimizer's) is `state_dict()`, so a checkpoint resumes
    the moments, momentum buffers and count exactly."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Schedule, grad_clip: Optional[float],
                 make: Callable[[List[Dict], float], torch.optim.Optimizer],
                 lr_scales: Optional[Sequence[float]] = None):
        self.params = list(params)
        scales = ([1.0] * len(self.params) if lr_scales is None
                  else [float(s) for s in lr_scales])
        if len(scales) != len(self.params):
            raise ValueError(f"{len(scales)} LR multipliers for "
                             f"{len(self.params)} parameters")
        groups: Dict[float, List[torch.nn.Parameter]] = {}
        for p, s in zip(self.params, scales):
            groups.setdefault(s, []).append(p)
        self.scales = list(groups)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.opt = make([{"params": ps} for ps in groups.values()],
                        schedule(0))

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def lr(self) -> float:
        """The base learning rate of the next update."""
        return self.schedule(self.count)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("every parameter needs a gradient (zero it, "
                               "as the PA freeze does, rather than drop it)")
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)
        lr = self.lr()
        for group, scale in zip(self.opt.param_groups, self.scales):
            group["lr"] = lr * scale
        self.opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        # "sgd": the key of checkpoints saved before the port had Adam
        self.opt.load_state_dict(state["opt"] if "opt" in state
                                 else state["sgd"])


class SGDNesterov(ClippedOptimizer):
    """clip -> L2 weight decay -> SGD with (nesterov) momentum."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Schedule, weight_decay: float = 1e-4,
                 momentum: float = 0.9, nesterov: bool = True,
                 grad_clip: Optional[float] = 1.0,
                 lr_scales: Optional[Sequence[float]] = None):
        super().__init__(
            params, schedule, grad_clip,
            lambda groups, lr: torch.optim.SGD(
                groups, lr=lr, momentum=momentum, nesterov=nesterov,
                weight_decay=weight_decay), lr_scales)


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    schedule: Schedule, weight_decay: float = 1e-4,
                    nesterov: bool = True,
                    grad_clip: Optional[float] = 1.0, eps: float = 1e-8,
                    lr_scales: Optional[Sequence[float]] = None
                    ) -> ClippedOptimizer:
    """Optimizer factory (agcn_tpu optim.py:117-133; reference
    load_optimizer, processor.py:395-430). The '-llrd' names are their
    base chain, given `lr_scales` from `llrd_scales` (`from_config`).
    'SAM*' names take their SGD chain ('SAM', 'SAM_SGD' -> 'sgd'); the
    train step adds SAM's second pass (`sam_rho`)."""
    key = name.lower()
    if key.startswith("sam"):
        key = key.replace("_sgd", "").replace("sam", "sgd")
    if key in ("sgd", "sgd-llrd"):
        return SGDNesterov(params, schedule, weight_decay,
                           nesterov=nesterov, grad_clip=grad_clip,
                           lr_scales=lr_scales)
    if key in ("adam", "adamw", "adamw-llrd"):
        # Adam: L2 decay on the gradient and optax's eps 1e-8 (agcn_tpu
        # optim.py:92-103); AdamW: decoupled decay, optax.adamw (:106-114)
        decoupled = key != "adam"
        eps = eps if decoupled else 1e-8
        return ClippedOptimizer(
            params, schedule, grad_clip,
            lambda groups, lr: OptaxAdam(groups, lr, weight_decay, eps,
                                         decoupled), lr_scales)
    raise ValueError(f"Unknown optimizer {name!r}")


def build_schedule(scheduler: str, base_lr: float, steps_per_epoch: int,
                   decay_epochs: Sequence[int], warm_up_epoch: int = 0,
                   num_epoch: int = 1, initial_lr: Optional[float] = None,
                   final_lr: Optional[float] = None) -> Schedule:
    """The LR schedule of a recipe, dispatched as agcn_tpu
    trainer.py:288-300: 'onecyclelr', 'cycliclr' / 'cycliclrtri2', and
    every other name the warmup + step decay."""
    if scheduler == "onecyclelr":
        return onecycle_schedule(base_lr, steps_per_epoch, num_epoch,
                                 warm_up_epoch, initial_lr or None,
                                 final_lr or None)
    if scheduler in ("cycliclr", "cycliclrtri2"):
        return cyclic_schedule(base_lr, steps_per_epoch,
                               "triangular2" if scheduler.endswith("tri2")
                               else "triangular")
    return warmup_step_schedule(base_lr, steps_per_epoch, decay_epochs,
                                warm_up_epoch)


def from_config(cfg, named_parameters: Iterable, steps_per_epoch: int
                ) -> ClippedOptimizer:
    """A config's optimizer over `named_parameters`, with its schedule
    (`.schedule`), wired as agcn_tpu trainer.py:288-306: LLRD multipliers
    only for an optimizer whose name holds LLRD and a factor that is not
    1; `llrd_factor` scales nothing for any other optimizer."""
    schedule = build_schedule(
        cfg.scheduler, cfg.base_lr, steps_per_epoch, cfg.step,
        cfg.warm_up_epoch, num_epoch=cfg.num_epoch,
        initial_lr=cfg.initial_lr, final_lr=cfg.final_lr)
    names, params = zip(*named_parameters)
    scales = (llrd_scales(names, cfg.llrd_factor)
              if "LLRD" in cfg.optimizer.upper() and cfg.llrd_factor != 1.0
              else None)
    return build_optimizer(cfg.optimizer, params, schedule,
                           cfg.weight_decay, cfg.nesterov,
                           grad_clip=cfg.grad_clip, eps=cfg.eps,
                           lr_scales=scales)
