"""Checkpoint save/load of the port's trainer
(counterpart of agcn_tpu/train/checkpoint.py and Trainer.save_checkpoint).

The port saves with `torch.save` one `.pt` dict: the model's
reference-named state dict (parameters and BN buffers), the optimizer
state (update count and momentum buffers), step, epoch and
`steps_per_epoch` (the schedule geometry a test-phase run rebuilds the LR
from). `--weights` reads such a file, and also the JAX package's npz or
pickled checkpoints and reference `.pt` state dicts through
`utils/weights.py`, for parameters and BN statistics.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from agcn_tpu_torch.utils import weights

_KIND = "agcn_tpu_torch checkpoint"


def save_checkpoint(path: str, model: nn.Module, optimizer_state: Dict,
                    step: int, epoch: int, steps_per_epoch: int) -> str:
    """Write `path` + '.pt' (atomically) and return its name."""
    out = path if path.endswith(".pt") else path + ".pt"
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = out + ".tmp"
    torch.save({"kind": _KIND, "model": state,
                "optimizer": _to_cpu(optimizer_state), "step": int(step),
                "epoch": int(epoch),
                "steps_per_epoch": int(steps_per_epoch)}, tmp)
    os.replace(tmp, out)
    return out


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def resolve_path(path: str) -> str:
    """A checkpoint named without its '.pt' suffix resolves to the file."""
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def load_checkpoint(path: str, model: str = "agcn",
                    model_args: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Read a checkpoint of a recipe's `model` and `model_args` into
    {"model": state dict, and for the port's own files "optimizer",
    "step", "epoch", "steps_per_epoch"}."""
    path = resolve_path(path)
    raw = weights.load_checkpoint(path)
    if isinstance(raw, dict) and raw.get("kind") == _KIND:
        return raw
    out: Dict[str, Any] = {"model": weights.model_state_dict(raw, model,
                                                             model_args)}
    if isinstance(raw, dict) and "steps_per_epoch" in raw:
        out["steps_per_epoch"] = int(raw["steps_per_epoch"])
    return out


def load_model_weights(model: nn.Module, state: Dict[str, torch.Tensor],
                       ignore: Sequence[str] = (),
                       log: Optional[Callable[[str], None]] = None) -> None:
    """Overlay `state` onto `model`, skipping names that contain one of
    the `ignore` substrings (reference --ignore-weights,
    processor.py:251-270); parameters the state lacks keep their init."""
    own = model.state_dict()
    kept = {}
    for name, value in state.items():
        if any(s in name for s in ignore):
            if log:
                log(f"ignored weight: {name}")
        elif name in own:
            kept[name] = value
        elif log:
            log(f"unexpected weight skipped: {name}")
    missing = sorted(set(own) - set(kept))
    if log:
        for name in missing:
            log(f"missing weight kept at init: {name}")
    model.load_state_dict(kept, strict=False)
