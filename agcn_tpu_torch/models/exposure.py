"""The per-block graphs of a forward, recorded while a caller asks
(the counterpart of the JAX units' `self.sow("intermediates", "g", a1)`,
agcn_tpu/models/agcn.py:102 and aagcn.py:140, which the live demo reads;
reference infer/inference_220802.py:518-560).

A unit that records, AGCN's `UnitGCN` and AAGCN's `AdaptiveGCN` (and
with it every AAGCN version and the AAGCN transformer, which reuse it),
carries `graph_record = None` and, when a list is set there, appends the
(B, K, V, V) combined adjacency `a1` that it hands to its aggregation, on
every formulation and the edge path: the tensor the kernel reads, neither
copied nor synchronized. Unset, the forward pays one attribute test.

`recording_graphs(model)` sets a list on each such unit for the length of
a `with` block and, on leaving it, fills the list it yielded in the JAX
recognizer's order. That recognizer lists the sown leaves with
`jax.tree_util.tree_leaves`, which sorts the keys of every level of the
intermediates dict: the unrolled blocks come as l1, l10, l2, ..., l9;
a `scan_blocks` AGCN's keys are l1, l2_4, l5, l6_7, l8, l9_10, each group
a stack whose leading axis the recognizer splits in block order
(agcn_tpu/infer/realtime.py:91-108), which gives l1 ... l10. A model
names its scanned groups in `scan_groups` (block -> (group, index)).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
from torch import nn


def _jax_key(model: nn.Module, name: str) -> Tuple:
    """The sort key of the unit at `name` in the JAX intermediates dict:
    its path, with a scanned block's name replaced by its group's and
    the block's index in the group last."""
    parts = name.split(".")
    group = getattr(model, "scan_groups", {}).get(parts[0])
    if group is None:
        return (*parts, 0)
    return (group[0], "block", *parts[1:], group[1])


@contextlib.contextmanager
def recording_graphs(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Record the `a1` of every unit of `model` that records, for the
    forwards run inside the block; the yielded list holds them, in the
    JAX recognizer's order, once the block is left."""
    units = [(name, m) for name, m in model.named_modules()
             if hasattr(m, "graph_record")]
    for _, m in units:
        m.graph_record = []
    graphs: List[torch.Tensor] = []
    try:
        yield graphs
    finally:
        found = []
        for name, m in units:
            found += [(_jax_key(model, name), g) for g in m.graph_record]
            m.graph_record = None
        graphs.extend(g for _, g in sorted(found, key=lambda kg: kg[0]))
