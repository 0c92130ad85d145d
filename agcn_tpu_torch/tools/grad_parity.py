"""Where the card's fp32 training gradients part from the CPU's.

    python -m agcn_tpu_torch.tools.grad_parity [--model agcn|aagcn]
        [--batch 4] [--seq 300] [--out FILE] [--card cuda] [--threads N]

One training step (forward, the recipe's loss, backward) of the NTU-60
AGCN of configs/ntu60_xview/train_joint.yaml (or, with --model aagcn,
the AAGCN of train_joint_aagcn.yaml) at full width with
`formulation: pallas`, seeded random weights and conditioned BatchNorm
(`condition_bn`), on the card and on the CPU, each held against a
float64 CPU step. The BatchNorm train-mode arithmetic is varied, all
variants with the statistics in fp32 and a = weight * rsqrt(var + eps):

  jax       var = E[x^2] - E[x]^2   y = x * a + (bias - mean * a)
            (agcn_tpu/ops/norm.py:67-77, 112-127; the port's)
  two_pass  var = E[(x - E[x])^2]   y = x * a + (bias - mean * a)
  centered  var = E[x^2] - E[x]^2   y = (x - mean) * a + bias
  both      var = E[(x - E[x])^2]   y = (x - mean) * a + bias

Every ReLU of the model is watched (`ReluProbe`): a run reports how many
ReLU inputs take the other sign of zero than in the run it is held
against ("flips"), and the largest float64 |input| among them over that
layer's mean |input|. A replayed run applies the CPU run's ReLU masks,
so both compute the same linear piece of the network, and reports how
far apart the two runs' ReLU inputs lie.

The float64 steps run the kernels' plain versions with every `.float()`
kept in float64; the card's float64 step against the CPU's separates a
fault of the card's path from fp32 rounding. Each run is reported as its
worst gradient's error over `grad_errors`' bar at 1e-3 (<= 1 passes).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from agcn_tpu_torch.ops.norm import BatchNorm

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAIN_CONFIGS = {m: os.path.join(REPO, "configs", "ntu60_xview", f)
                 for m, f in (("agcn", "train_joint.yaml"),
                              ("aagcn", "train_joint_aagcn.yaml"))}
# the ReLUs of one block, in the order a forward calls them
BLOCK_RELUS = {"agcn": ("gcn1", "out"),
               "aagcn": ("gcn1", "attn_c", "out")}
SEED = 0


# conv biases whose gradient is zero in exact arithmetic: a BatchNorm
# follows them (conv_d, down, tcn, residual), or the attention softmax is
# invariant to them (conv_a: a shift along the softmax axis)
EXACT_ZERO = re.compile(
    r"(conv_a\.\d+|conv_d\.\d+|down\.0|tcn1\.conv|residual\.conv)\.bias$")


def grad_errors(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                rel: float) -> List[Tuple[float, str, float, float]]:
    """[(err / bar, name, max abs err, tensor scale)], worst first. The bar
    is `rel` of the reference tensor's max |value| plus 1e-7 of the
    largest gradient's, about one fp32 rounding of it (gradients small by
    cancellation, such as a BN bias summed over a nearly zero-mean
    cotangent). The EXACT_ZERO gradients come out of fp32 as rounding
    noise of the other gradients' size: their bar is 1e-5 of the largest
    gradient."""
    top = max(g.abs().max().item() for g in ref.values())
    rows = []
    for name, want in ref.items():
        scale = want.abs().max().item()
        err = (grads[name] - want).abs().max().item()
        bar = (1e-5 * top if EXACT_ZERO.search(name)
               else rel * scale + 1e-7 * top)
        rows.append((err / bar, name, err, scale))
    return sorted(rows, reverse=True)


def condition_bn(model: torch.nn.Module, seed: int) -> None:
    """BN shifts of 0.5-0.7 over scales of 0.1-0.2 put most ReLU inputs
    some 4 standard deviations above zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(0.1 + 0.1 * torch.rand(n, generator=g))
                m.bias.copy_(0.5 + 0.2 * torch.rand(n, generator=g))


def relu_name(i: int, block: Tuple[str, ...] = BLOCK_RELUS["agcn"]) -> str:
    """The i-th ReLU of a forward whose blocks call `block`'s ReLUs in
    turn (AGCN: each block's GCN unit, then the block's output)."""
    return f"l{i // len(block) + 1}.{block[i % len(block)]}"


class ReluProbe:
    """Stands in for `torch.relu` during one step and records each call's
    mask (input > 0) on the CPU; with `keep_inputs` also the inputs (in
    fp32), with `keep_margin` |input| over the call's mean |input|.

    Given `ref`, another run's probe, it replays ref's masks (x where the
    mask is set, 0 elsewhere), so that both runs compute the same linear
    piece of the network, and measures how far apart the two runs' ReLU
    inputs lie: `disagree` counts the inputs whose own sign differs from
    ref's mask and, where ref kept its inputs, `input_diff` is the largest
    |input - ref's input| over ref's mean |input| of the call."""

    def __init__(self, ref: Optional["ReluProbe"] = None,
                 keep_inputs: bool = False, keep_margin: bool = False):
        self.ref = ref
        self.keep_inputs = keep_inputs
        self.keep_margin = keep_margin
        self.masks: List[torch.Tensor] = []
        self.inputs: List[torch.Tensor] = []
        self.margins: List[torch.Tensor] = []
        self.disagree = 0
        self.input_diff = 0.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pre = x.detach()
        i = len(self.masks)
        self.masks.append((pre > 0).cpu())
        if self.keep_inputs:
            self.inputs.append(pre.float().cpu())
        if self.keep_margin:
            a = pre.abs()
            self.margins.append((a / a.mean()).float().cpu())
        if self.ref is None:
            return _RELU(x)
        want = self.ref.masks[i].to(x.device)
        self.disagree += int((want != (pre > 0)).sum())
        if self.ref.inputs:
            r = self.ref.inputs[i].to(x.device)
            self.input_diff = max(self.input_diff, float(
                (pre.float() - r).abs().max() / r.abs().mean()))
        return torch.where(want, x, 0.0)


_RELU = torch.relu


@contextlib.contextmanager
def relu_probe(probe: ReluProbe):
    torch.relu = probe
    try:
        yield
    finally:
        torch.relu = _RELU


def flips(masks: List[torch.Tensor], ref: List[torch.Tensor],
          margins: List[torch.Tensor],
          block: Tuple[str, ...] = BLOCK_RELUS["agcn"]) -> Dict[str, object]:
    """The ReLU inputs whose sign differs from `ref`'s, with the largest
    float64 margin among them and where it lies (b, t, v, c)."""
    count, worst, where = 0, 0.0, None
    for i, (m, r) in enumerate(zip(masks, ref)):
        diff = m != r
        n = int(diff.sum())
        if not n:
            continue
        count += n
        mg = torch.where(diff, margins[i], torch.zeros(()))
        j = int(mg.argmax())
        if mg.flatten()[j] >= worst:
            worst = float(mg.flatten()[j])
            where = [relu_name(i, block)] + [int(k) for k in np.unravel_index(
                j, tuple(mg.shape))]
    return dict(flips=count, max_margin=worst, at=where)


def near_zero(margins: List[torch.Tensor], within: float = 1e-6,
              block: Tuple[str, ...] = BLOCK_RELUS["agcn"]
              ) -> Dict[str, object]:
    """The float64 ReLU inputs within `within` of their layer's mean
    |input| of zero, and the smallest margin."""
    n = sum(int((m < within).sum()) for m in margins)
    low = min((float(m.min()), relu_name(i, block))
              for i, m in enumerate(margins))
    return dict(within=within, count=n, min_margin=low[0], at=low[1],
                inputs=sum(m.numel() for m in margins))


@contextlib.contextmanager
def plain_versions_on_the_card():
    """The kernels' plain versions in place of their launches, so that the
    same step runs on the card with and without the port's kernels."""
    from agcn_tpu_torch.ops.kernels import gcn_fused

    launches = gcn_fused.launch_gcn_fwd, gcn_fused.launch_gcn_bwd
    gcn_fused.launch_gcn_fwd = gcn_fused.gcn_fwd_plain
    gcn_fused.launch_gcn_bwd = gcn_fused.gcn_bwd_plain
    try:
        yield
    finally:
        gcn_fused.launch_gcn_fwd, gcn_fused.launch_gcn_bwd = launches


@contextlib.contextmanager
def float_keeps_float64():
    """`.float()` leaves float64 tensors alone: the port's fp32 casts (BN
    statistics, the softmax, the pooling, the plain kernels' sums) stay
    in float64 for the reference step."""
    to_float = torch.Tensor.float

    def keep(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return to_float(self, *args, **kwargs)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def _bn_train(two_pass: bool, centered: bool) -> Callable:
    """A BatchNorm train-mode forward (the running statistics left alone:
    one step's gradients do not read them)."""
    def forward(self, x):
        if not self.training:
            return _BN_FORWARD(self, x)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        if two_pass:
            var = (xf - mean).square().mean(dim=dims)
        else:
            var = (xf * xf).mean(dim=dims) - mean * mean
        a = self.weight.float() * torch.rsqrt(var + self.eps)
        if centered:
            y = (xf - mean) * a + self.bias.float()
        else:
            y = xf * a + (self.bias.float() - mean * a)
        return y.to(x.dtype)
    return forward


_BN_FORWARD = BatchNorm.forward
VARIANTS = {"jax": _bn_train(False, False),
            "two_pass": _bn_train(True, False),
            "centered": _bn_train(False, True),
            "both": _bn_train(True, True)}


@contextlib.contextmanager
def bn_variant(name: str):
    BatchNorm.forward = VARIANTS[name]
    try:
        yield
    finally:
        BatchNorm.forward = _BN_FORWARD


def step_grads(model: torch.nn.Module, loss_fn: Callable, x: torch.Tensor,
               y: torch.Tensor) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {name: gradient on the CPU}) of one train-mode step."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model(x), y)
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu()
                         for n, p in model.named_parameters()}


def main(argv=None) -> int:
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.train import losses
    from agcn_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(TRAIN_CONFIGS), default="agcn")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=300)
    ap.add_argument("--card", default="cuda",
                    help="the device held against the CPU (cpu rehearses)")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1,
                    help="CPU threads of the CPU steps")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(args.threads)
    cfg = load_config(TRAIN_CONFIGS[args.model])
    block = BLOCK_RELUS[args.model]
    model_args = dict(cfg.model_args, formulation="pallas")
    loss_fn = losses.build_loss(cfg.loss, model_args["num_class"])
    rng = np.random.default_rng(SEED + 4)
    x = rng.standard_normal((args.batch, 3, args.seq, 25, 2)).astype(
        np.float32)
    y = rng.integers(0, model_args["num_class"], args.batch)
    state = None

    def run(dev, dtype, variant, probe, plain=False):
        nonlocal state
        model = build_model(cfg.model, model_args, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
        if state is None:
            condition_bn(model, SEED + 6)
            state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
        model.load_state_dict(state, strict=True)
        xt = torch.from_numpy(x).to(dev)
        if dtype == torch.float64:
            model, xt = model.double(), xt.double()
        with contextlib.ExitStack() as scopes:
            scopes.enter_context(bn_variant(variant))
            scopes.enter_context(relu_probe(probe))
            if dtype == torch.float64:
                scopes.enter_context(float_keeps_float64())
            if plain and dev != "cpu":
                scopes.enter_context(plain_versions_on_the_card())
            t0 = time.perf_counter()
            loss, grads = step_grads(model, loss_fn, xt,
                                     torch.from_numpy(y).to(dev))
        return dict(loss=loss, grads=grads, probe=probe,
                    seconds=time.perf_counter() - t0)

    truth = run("cpu", torch.float64, "jax", ReluProbe(keep_margin=True))
    margins = truth["probe"].margins
    rows = [dict(run="cpu float64", near_zero=near_zero(margins,
                                                        block=block),
                 seconds=truth["seconds"])]
    print(f"cpu float64: ReLU inputs near zero {rows[0]['near_zero']}",
          flush=True)

    def report(label, got, ref, against):
        errs = grad_errors(got["grads"], ref["grads"], 1e-3)
        row = dict(run=label, against=against, loss=got["loss"],
                   loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                   worst=errs[0][0],
                   top=max(g.abs().max().item()
                           for g in ref["grads"].values()),
                   passing=sum(r[0] <= 1 for r in errs),
                   tensors=len(errs), top3=[list(r) for r in errs[:3]],
                   seconds=got["seconds"])
        if got["probe"].ref is None:
            row.update(flips(got["probe"].masks, ref["probe"].masks, margins,
                             block))
        else:
            row.update(flips=got["probe"].disagree, replayed=True,
                       input_diff=got["probe"].input_diff)
        rows.append(row)
        print(f"{label:32s} vs {against:13s} worst {row['worst']:8.4g} "
              f"pass {row['passing']}/{row['tensors']} loss "
              f"{row['loss_rel']:.1e} flips {row['flips']}"
              + (f" (max float64 margin {row['max_margin']:.2e} at "
                 f"{row['at']})" if row.get("at") else "")
              + (f" (ReLU inputs {row['input_diff']:.2e} of their mean "
                 "apart)" if row.get("replayed") else "")
              + f" {got['seconds']:.1f} s; worst "
              + "; ".join(f"{r[1]} {r[2]:.2e}/{r[3]:.2e}"
                          for r in errs[:2])
              + f" (largest gradient {row['top']:.3g})", flush=True)

    card64 = run(args.card, torch.float64, "jax", ReluProbe(), plain=True)
    report(f"{args.card} float64 plain", card64, truth, "cpu float64")
    for variant in VARIANTS:
        cpu = run("cpu", torch.float32, variant, ReluProbe(keep_inputs=True))
        card = run(args.card, torch.float32, variant, ReluProbe())
        replay = run(args.card, torch.float32, variant,
                     ReluProbe(ref=cpu["probe"]))
        report(f"cpu fp32 {variant}", cpu, truth, "cpu float64")
        report(f"{args.card} fp32 {variant}", card, truth, "cpu float64")
        report(f"{args.card} fp32 {variant}", card, cpu, "cpu fp32")
        report(f"{args.card} fp32 {variant} cpu's masks", replay, cpu,
               "cpu fp32")
    if args.card != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    else:
        smi = "cpu rehearsal"
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, model=args.model, batch=args.batch,
                           seq=args.seq, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
