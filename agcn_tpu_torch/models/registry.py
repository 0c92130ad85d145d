"""Model registry (port of agcn_tpu/models/registry.py: AGCN and AAGCN).

Models are selected by short name; the reference's dotted paths for the
ported models are aliased so its config files work unchanged. Graph
construction (the `graph`/`graph_args` model args) resolves through
agcn_tpu_torch.graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models.aagcn import AAGCN
from agcn_tpu_torch.models.agcn import AGCN
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE

_ALIASES = {
    "model.agcn.Model": "agcn",
    "model.aagcn.Model": "aagcn",
    "model.architecture.aagcn.agcn.Model": "agcn",
    "model.architecture.aagcn.aagcn.Model": "aagcn",
}
_CLASSES = {"agcn": AGCN, "aagcn": AAGCN}
# the JAX package's other models, each with the ROADMAP item it waits in
_WAITING = (("aagcn_transformer", "Queue 1 item 6: aagcn_transformer"),
            ("aagcn_v", "Queue 1 item 6: aagcn_versions"),
            ("model.aagcn_v", "Queue 1 item 6: aagcn_versions"),
            ("model.architecture.aagcn.aagcn_v",
             "Queue 1 item 6: aagcn_versions"),
            ("sgn", "Queue 1 item 7: SGN family"),
            ("model.sgn", "Queue 1 item 7: SGN family"),
            ("model.architecture.sgn", "Queue 1 item 7: SGN family"))


def model_key(name: str) -> str:
    """The registry key of a recipe's `model` (a short name or a reference
    dotted path)."""
    return _ALIASES.get(name, name).lower()


def build_model(name: str, model_args: Dict[str, Any],
                device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a model from a recipe's `model` and `model_args`, on `device`
    (`cuda` unless named), computing in `dtype`, initialized from
    `generator`."""
    key = model_key(name)
    cls = _CLASSES.get(key)
    if cls is None:
        for prefix, item in _WAITING:
            if key.startswith(prefix.lower()):
                raise NotImplementedError(
                    f"model {name!r} is not ported yet: it waits in "
                    f"ROADMAP {item}")
        raise KeyError(f"Unknown model {name!r}")
    args = dict(model_args)
    graph = args.pop("graph", "ntu_rgb_d")
    graph_args = args.pop("graph_args", {})
    adj = build_adjacency(graph, **graph_args)
    # reference arg names that the models fix: K = 3 subsets, and the
    # original AGCN Model takes no drop_out (reference agcn.py:133)
    args.pop("num_subset", None)
    if cls is AGCN:
        args.pop("drop_out", None)
    return cls(adj=adj, device=device, dtype=dtype, generator=generator,
               **args)
