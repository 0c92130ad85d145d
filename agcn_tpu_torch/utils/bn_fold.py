"""Eval-time BatchNorm folding (port of agcn_tpu/utils/bn_fold.py).

At eval a BatchNorm is the per-channel affine y = x * a + b with
a = weight / sqrt(running_var + eps) and b = bias - running_mean * a
(ops/norm.py). For each conv -> BN pair the affine goes into the conv's
weight and bias, and the BN is then neutralized to the identity (weight
1, bias 0, mean 0, var 1 - eps: a = 1, b = 0). A model built with
`fold_bn=True` skips those BNs at eval (`identity_at_eval`); one built
without it computes the same logits from the folded weights, one
identity affine a BN slower.

Folded for AGCN (models/agcn.py) and AAGCN (models/aagcn.py): each
block's aggregation BN (into the K `conv_d` projections, whose summed
output it normalizes: each weight and bias scaled by a, the shift b added
once, to `conv_d.0`'s bias), its down BN, its TCN BN and its residual BN.
`data_bn` stays live: it feeds the first block's attention and residual
paths, so no single conv absorbs it. Ghost BN (`gbn_split`) folds the
same way: at eval it applies the running statistics' affine. Eval only:
training from folded weights trains another model.

The functions take the port's state dict (the reference torch names, as
`model.state_dict()` gives it) and return a new one; the input is left as
it is. A `scan_blocks` AGCN has the unrolled model's state dict (its JAX
checkpoint is unstacked on loading), so it folds as any other, as in
agcn_tpu/utils/bn_fold.py:77. AAGCN registers a unit's `conv_d` twice, as
`gcn1.conv_d.k` and `gcn1.agcn.conv_d.k` (the reference's double
registration), so its state dict holds two keys for each of those
tensors: each is folded once, from the unit's key, and written under
both.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

EPS = 1e-5  # the port's BatchNorm epsilon (ops/norm.py)
_BLOCK = re.compile(r"^(l\d+)\.")
_SCAN = re.compile(r"^l\d+_\d+\.")  # a scan_blocks group's key


def _affine(sd: Mapping[str, torch.Tensor], prefix: str):
    """(a, b) of the eval BN at `prefix`, in fp32."""
    a = sd[f"{prefix}.weight"].float() / torch.sqrt(
        sd[f"{prefix}.running_var"].float() + EPS)
    b = sd[f"{prefix}.bias"].float() - sd[f"{prefix}.running_mean"].float() * a
    return a, b


def _neutralize(out: Dict[str, torch.Tensor], prefix: str) -> None:
    ones = torch.ones_like(out[f"{prefix}.weight"], dtype=torch.float32)
    out[f"{prefix}.weight"] = ones
    out[f"{prefix}.bias"] = torch.zeros_like(ones)
    out[f"{prefix}.running_mean"] = torch.zeros_like(ones)
    # var such that 1 / sqrt(var + eps) == 1
    out[f"{prefix}.running_var"] = torch.full_like(ones, 1.0 - EPS)


def _scale_out(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A conv weight (out, in, ...) with output channel o scaled by a[o]."""
    return w.float() * a.reshape((-1,) + (1,) * (w.dim() - 1))


def _fold_conv(out: Dict[str, torch.Tensor], sd: Mapping[str, torch.Tensor],
               conv: str, bn: str) -> None:
    """y = conv(x) * a + b into the conv at `conv`, then the BN at `bn`
    neutralized."""
    a, b = _affine(sd, bn)
    out[f"{conv}.weight"] = _scale_out(sd[f"{conv}.weight"], a)
    out[f"{conv}.bias"] = sd[f"{conv}.bias"].float() * a + b
    _neutralize(out, bn)


def _blocks(sd: Mapping[str, torch.Tensor]):
    scan = next((key for key in sd if _SCAN.match(key)), None)
    if scan is not None:
        # a JAX scan_blocks tree flattened as it is: its leaves are
        # stacked on a leading axis, and no port model has these names
        raise ValueError(
            f"{scan}: a JAX scan_blocks group (block parameters stacked on "
            "a leading axis); convert the checkpoint with "
            "utils.weights.agcn_state_dict_from_variables, which unstacks "
            "it into the blocks of the port's model, and fold that")
    return sorted({m.group(1) for m in map(_BLOCK.match, sd) if m},
                  key=lambda b: int(b[1:]))


def _fold(sd: Mapping[str, torch.Tensor],
          conv_d_aliases: tuple) -> Dict[str, torch.Tensor]:
    out = dict(sd)
    for block in _blocks(sd):
        g = f"{block}.gcn1"
        a, b = _affine(sd, f"{g}.bn")
        k = 0
        while f"{g}.conv_d.{k}.weight" in sd:
            w = _scale_out(sd[f"{g}.conv_d.{k}.weight"], a)
            bias = sd[f"{g}.conv_d.{k}.bias"].float() * a
            if k == 0:  # the BN's shift lands once in the summed bias
                bias = bias + b
            for prefix in conv_d_aliases:
                name = f"{g}.{prefix}conv_d.{k}"
                if f"{name}.weight" in sd:
                    out[f"{name}.weight"] = w
                    out[f"{name}.bias"] = bias
            k += 1
        _neutralize(out, f"{g}.bn")
        if f"{g}.down.0.weight" in sd:
            _fold_conv(out, sd, f"{g}.down.0", f"{g}.down.1")
        _fold_conv(out, sd, f"{block}.tcn1.conv", f"{block}.tcn1.bn")
        if f"{block}.residual.conv.weight" in sd:
            _fold_conv(out, sd, f"{block}.residual.conv",
                       f"{block}.residual.bn")
    return out


def fold_agcn_bn_eval(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A new AGCN state dict with every block's BNs folded into the
    adjacent convs (exact at eval; agcn_tpu bn_fold.py:68-104)."""
    return _fold(state_dict, ("",))


def fold_aagcn_bn_eval(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A new AAGCN state dict with every unit's BNs folded into the
    adjacent convs (exact at eval; agcn_tpu bn_fold.py:107-144). The STC
    attention applies after the BN and ReLU and is left as it is; the
    non-adaptive unit's `conv_d` (under the unit only) folds the same
    way."""
    return _fold(state_dict, ("", "agcn."))
