"""Model registry (port of agcn_tpu/models/registry.py, AGCN only).

Models are selected by short name; the reference's dotted paths for AGCN
are aliased so its config files work unchanged. Graph construction (the
`graph`/`graph_args` model args) resolves through agcn_tpu_torch.graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models.agcn import AGCN
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE

_ALIASES = {
    "model.agcn.Model": "agcn",
    "model.architecture.aagcn.agcn.Model": "agcn",
}


def build_model(name: str, model_args: Dict[str, Any],
                device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> AGCN:
    """Build a model from a recipe's `model` and `model_args`, on `device`
    (`cuda` unless named), computing in `dtype`, initialized from
    `generator`."""
    key = _ALIASES.get(name, name).lower()
    if key != "agcn":
        raise NotImplementedError(
            f"model {name!r} is not ported yet: the port serves AGCN; "
            "AAGCN and the SGN family wait in ROADMAP Queue 1")
    args = dict(model_args)
    graph = args.pop("graph", "ntu_rgb_d")
    graph_args = args.pop("graph_args", {})
    adj = build_adjacency(graph, **graph_args)
    # reference arg names that the model fixes: K = 3 subsets, and the
    # original AGCN Model takes no drop_out (reference agcn.py:133)
    args.pop("num_subset", None)
    args.pop("drop_out", None)
    return AGCN(adj=adj, device=device, dtype=dtype, generator=generator,
                **args)
