"""Adjacency construction (copy of agcn_tpu/graph/build.py).

The (K, V, V) spatial partition stack of the reference's graph/tools.py:
identity, in-degree-normalized inward and outward edges; the STGAT graph
builders of graph/tools.py:33-134 and graph/ntu_rgb_d.py:35-45 (binary,
k-hop, separated and k-total adjacencies, the spatio-temporal tiling, the
expanded and strengthened NTU graphs, the adjacency bundle); and each
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


def binary_adjacency(skeleton: Skeleton, with_self: bool = True) -> np.ndarray:
    """Symmetric binary adjacency, optionally with self loops."""
    v = skeleton.num_joints
    edges = skeleton.neighbor + (skeleton.self_loops if with_self else ())
    a = np.zeros((v, v), dtype=np.float32)
    for e in edges:
        a[e] = 1.0
    return a


def k_adjacency(a: np.ndarray, k: int, with_self: bool = False,
                self_factor: float = 1.0) -> np.ndarray:
    """k-hop shell adjacency (reference graph/tools.py:97-106)."""
    identity = np.eye(len(a), dtype=a.dtype)
    if k == 0:
        return identity
    ak = (np.minimum(np.linalg.matrix_power(a + identity, k), 1)
          - np.minimum(np.linalg.matrix_power(a + identity, k - 1), 1))
    if with_self:
        ak = ak + self_factor * identity
    return ak


def separated_adjacency(a: np.ndarray, k_list) -> np.ndarray:
    """Stack of hop-shell adjacencies between consecutive hop counts in
    k_list, each with self loops (reference graph/tools.py:108-118)."""
    identity = np.eye(len(a), dtype=a.dtype)
    out = []
    for k1, k2 in zip(k_list[:-1], k_list[1:]):
        out.append(np.minimum(np.linalg.matrix_power(a, k2), 1)
                   - np.minimum(np.linalg.matrix_power(a, k1), 1)
                   + identity)
    return np.stack(out)


def k_total_adjacency(a: np.ndarray, k: int) -> np.ndarray:
    """Reachability within k hops (reference graph/tools.py:121-127)."""
    if k == 0:
        return np.eye(len(a), dtype=a.dtype)
    return np.minimum(np.linalg.matrix_power(a, k), 1)


def spatial_temporal_graph(a_binary: np.ndarray,
                           sample_size: int) -> np.ndarray:
    """Tile a joint graph over `sample_size` time steps
    (reference graph/tools.py:88-94)."""
    return np.tile(a_binary, (sample_size, sample_size)).copy()


# the part-level links of the 6 virtual nodes (25 upper-left, 26
# upper-right, 27 up, 28 middle, 29 lower-left, 30 lower-right) of each
# expanded-graph variant (reference graph/tools.py:33-72)
_EXPANDED_LINKS = {
    1: [(25, 26), (25, 27), (26, 27),
        (28, 25), (28, 26), (28, 27), (28, 29), (28, 30),
        (29, 30)],
    2: [(25, 4), (25, 5), (25, 6), (25, 7), (25, 21),
        (25, 22), (25, 26), (25, 27),
        (26, 8), (26, 9), (26, 10), (26, 11), (26, 23),
        (26, 24), (26, 27),
        (27, 2), (27, 3),
        (28, 0), (28, 1), (28, 20), (28, 25), (28, 26),
        (28, 27), (28, 29), (28, 30),
        (29, 12), (29, 13), (29, 14), (29, 15), (29, 30),
        (30, 16), (30, 17), (30, 18), (30, 19)]}
# the skeleton edges variant 2 replaces by its part links
_EXPANDED_DROPPED = {1: (), 2: ((16, 0), (12, 0), (4, 20), (8, 20))}


def expanded_graph(skeleton: Skeleton, variant: int = 1) -> np.ndarray:
    """STGAT expanded graph: 6 virtual part-nodes appended to NTU-25
    (upper-left/right, up, middle, lower-left/right) with part-level
    links (reference graph/tools.py:33-72). Edges are set as
    A[i, j] = 1 directly (STGAT convention), symmetrized, + I."""
    if variant not in _EXPANDED_LINKS:
        raise ValueError(f"unknown expanded-graph variant {variant}")
    n = skeleton.num_joints
    inward = list(skeleton.inward) + _EXPANDED_LINKS[variant]
    for drop in _EXPANDED_DROPPED[variant]:
        inward.remove(drop)
    a = np.zeros((n + 6, n + 6), dtype=np.float32)
    for i, j in inward:
        a[i, j] = 1.0
        a[j, i] = 1.0
    return a + np.eye(n + 6, dtype=np.float32)


def strengthened_graph(skeleton: Skeleton) -> np.ndarray:
    """STGAT strengthened graph: extra limb shortcuts within arms/legs
    (reference graph/tools.py:75-86), symmetrized, + I."""
    n = skeleton.num_joints
    inward = list(skeleton.inward) + [
        (14, 12), (15, 12), (19, 16), (18, 16),
        (21, 4), (22, 4), (6, 4), (7, 4),
        (23, 8), (24, 8), (10, 8), (11, 8)]
    a = np.zeros((n, n), dtype=np.float32)
    for i, j in inward:
        a[i, j] = 1.0
        a[j, i] = 1.0
    return a + np.eye(n, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class AdjMatrixGraph:
    """STGAT-style adjacency bundle (reference graph/ntu_rgb_d.py:35-45):
    binary adjacency, +self-loops, sym-normalized, and the 12-shell
    separated stack."""

    a_binary: np.ndarray
    a_binary_with_i: np.ndarray
    a: np.ndarray
    a_sep: np.ndarray


def adj_matrix_graph(name: str = "ntu_rgb_d") -> AdjMatrixGraph:
    a_bin = binary_adjacency(get_skeleton(name), with_self=False)
    a_bin_i = a_bin + np.eye(len(a_bin), dtype=np.float32)
    return AdjMatrixGraph(
        a_binary=a_bin,
        a_binary_with_i=a_bin_i,
        a=normalize_symmetric(a_bin_i).astype(np.float32),
        a_sep=separated_adjacency(a_bin_i, list(range(13))),
    )


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
