"""Adjacency construction (copy of the dense part and the COO edge sets of
agcn_tpu/graph/build.py).

The (K, V, V) spatial partition stack of the reference's graph/tools.py:
identity, in-degree-normalized inward and outward edges; and each
subset's edges in COO form (`EdgeSet`), partitionable by edge for the
edge-partitioned aggregation (parallel/edge_partition.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

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


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """COO edge structure for one adjacency subset, partitionable by edge
    (agcn_tpu/graph/build.py:203-236).

    Arrays are index-sorted by destination joint so a partition is a
    contiguous slice and segment-sum aggregation is monotone.
    """

    src: np.ndarray    # (E,) int32 source joint per edge
    dst: np.ndarray    # (E,) int32 destination joint per edge
    weight: np.ndarray  # (E,) float32 normalized edge weight
    num_joints: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.num_joints, self.num_joints), dtype=np.float32)
        a[self.dst, self.src] = self.weight
        return a

    def partition(self, num_parts: int) -> Tuple["EdgeSet", ...]:
        """Split edges into contiguous near-equal parts (by edge count):
        each edge rank of parallel/edge_partition.py owns one."""
        bounds = np.linspace(0, self.num_edges, num_parts + 1).astype(int)
        return tuple(
            EdgeSet(self.src[s:e], self.dst[s:e], self.weight[s:e],
                    self.num_joints)
            for s, e in zip(bounds[:-1], bounds[1:])
        )


def dense_to_edges(a: np.ndarray) -> EdgeSet:
    """Convert one dense (V, V) adjacency (A[dst, src]) to COO form."""
    dst, src = np.nonzero(a)
    order = np.lexsort((src, dst))
    return EdgeSet(
        src=src[order].astype(np.int32),
        dst=dst[order].astype(np.int32),
        weight=a[dst, src][order].astype(np.float32),
        num_joints=a.shape[-1],
    )


def spatial_edge_sets(name: str) -> Tuple[EdgeSet, ...]:
    """COO form of each spatial-partition subset."""
    return tuple(dense_to_edges(a) for a in build_adjacency(name))
