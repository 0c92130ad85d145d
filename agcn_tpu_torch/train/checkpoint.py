"""Checkpoint save/load of the port's trainer
(counterpart of agcn_tpu/train/checkpoint.py and Trainer.save_checkpoint).

The port saves with `torch.save` one `.pt` dict: the model's
reference-named state dict (parameters and BN buffers), the optimizer
state (update count, and momentum buffers or Adam's moments), step,
epoch and
`steps_per_epoch` (the schedule geometry a test-phase run rebuilds the LR
from). `--weights` reads such a file, and also the JAX package's npz or
pickled checkpoints and reference `.pt` state dicts through
`utils/weights.py`, for parameters and BN statistics.

With `async_save` (the recipes' `async_checkpoint`; agcn_tpu
checkpoint.py:42-103) the call returns once the snapshot is on the host:
every tensor copied there, the copies awaited, so the next step's
in-place updates cannot reach it. A background thread writes the file
with the same temp-then-rename. `wait_for_checkpoints()` blocks until
every save has committed and raises the first failed write; every save
waits for the one before it, so at most one is in flight and a failure
surfaces at the next save at the latest.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from agcn_tpu_torch.utils import weights

_KIND = "agcn_tpu_torch checkpoint"


_pending: List[threading.Thread] = []
_failed: List[BaseException] = []


def save_checkpoint(path: str, model: nn.Module, optimizer_state: Dict,
                    step: int, epoch: int, steps_per_epoch: int,
                    async_save: bool = False) -> str:
    """Write `path` + '.pt' (atomically) and return its name; with
    `async_save` the write runs in a background thread."""
    wait_for_checkpoints()
    out = path if path.endswith(".pt") else path + ".pt"
    payload = {"kind": _KIND, "model": model.state_dict(),
               "optimizer": optimizer_state, "step": int(step),
               "epoch": int(epoch), "steps_per_epoch": int(steps_per_epoch)}
    snapshot = _to_cpu(payload)
    if not async_save:
        _write(snapshot, out)
        return out
    thread = threading.Thread(target=_write_in_background,
                              args=(snapshot, out), daemon=False,
                              name=f"checkpoint {os.path.basename(out)}")
    _pending.append(thread)
    thread.start()
    return out


def wait_for_checkpoints() -> None:
    """Block until every background save has committed; raise the first
    write that failed."""
    while _pending:
        _pending.pop(0).join()
    if _failed:
        err = _failed[0]
        _failed.clear()
        raise RuntimeError(f"a background checkpoint write failed: "
                           f"{err!r}") from err


def _write(payload: Dict, out: str) -> None:
    tmp = out + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)


def _write_in_background(payload: Dict, out: str) -> None:
    try:
        _write(payload, out)
    except BaseException as e:  # raised at the next save or wait
        _failed.append(e)


def _to_cpu(tree: Any) -> Any:
    """A host copy of every tensor of `tree` that no later in-place update
    reaches (a CUDA tensor's copy is awaited)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
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
