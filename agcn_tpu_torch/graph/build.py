"""Adjacency construction (copy of the dense part of agcn_tpu/graph/build.py).

The (K, V, V) spatial partition stack of the reference's graph/tools.py:
identity, in-degree-normalized inward and outward edges.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from agcn_tpu_torch.graph.skeletons import Edge, Skeleton, get_skeleton


def edge2mat(edges: Iterable[Edge], num_joints: int) -> np.ndarray:
    """Directed adjacency: A[target, source] = 1 for each (source, target)."""
    a = np.zeros((num_joints, num_joints), dtype=np.float64)
    for src, dst in edges:
        a[dst, src] = 1.0
    return a


def normalize_in_degree(a: np.ndarray) -> np.ndarray:
    """Column-normalize: A @ D^-1 with D the column-sum diagonal."""
    deg = a.sum(axis=0)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return a * inv[None, :]


def normalize_symmetric(a: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2 with row-sum degrees (reference graph/tools.py:130-134)."""
    deg = a.sum(axis=-1)
    inv_sqrt = np.power(np.maximum(deg, 1e-12), -0.5)
    inv_sqrt = np.where(deg > 0, inv_sqrt, 0.0)
    return (inv_sqrt[:, None] * a * inv_sqrt[None, :]).astype(np.float64)


def spatial_graph(skeleton: Skeleton) -> np.ndarray:
    """3-subset spatial partition stack (I, norm-inward, norm-outward),
    float32 (3, V, V)."""
    v = skeleton.num_joints
    identity = edge2mat(skeleton.self_loops, v)
    inward = normalize_in_degree(edge2mat(skeleton.inward, v))
    outward = normalize_in_degree(edge2mat(skeleton.outward, v))
    return np.stack([identity, inward, outward]).astype(np.float32)


def build_adjacency(name: str, labeling_mode: str = "spatial") -> np.ndarray:
    """Build the (K, V, V) adjacency stack for a named skeleton."""
    if labeling_mode != "spatial":
        raise ValueError(f"Unknown labeling mode {labeling_mode!r}")
    return spatial_graph(get_skeleton(name))
