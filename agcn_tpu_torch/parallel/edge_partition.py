"""Edge-partitioned graph aggregation over the mesh's 'edge' axis (port of
agcn_tpu/parallel/edge_partition.py).

The skeleton graph is tiny (V <= 25) but every (batch, frame) instance
applies the same K x E edges. The edge set is partitioned across the
'edge' ranks: each owns a contiguous slice of each subset's edge list
(graph.EdgeSet.partition), aggregates only its local edges as a dense
masked einsum, and the ranks' partial destination features are summed
over the edge axis' process group.

Every function runs on each edge rank of a mesh (parallel/mesh.py) with
the same inputs, replicated over the axis, and returns the same result
on each. The collectives are those of parallel/collectives.py, so the
functions are differentiable: a replicated input's gradient is the sum of
the ranks' shares, and the output's gradient passes to each rank's share
whole. Combiners, as in the JAX package:

- psum: one all-reduce;
- ppermute: a ring of P - 1 send/receive hops (`dist.batch_isend_irecv`),
  accumulating the partials hop by hop.

`model_edge_gcn`, the models' in-model path, combines with a
reduce-scatter over P time chunks then an all-gather of the reduced
chunks: the two phases of JAX's time-chunked ring, as two NCCL (or gloo)
collectives. The JAX ring overlaps its hops with the next chunk's einsum;
here each collective runs after the rank's whole partial. These are
library collectives over torch einsums: no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agcn_tpu_torch.graph import dense_to_edges
from agcn_tpu_torch.parallel.collectives import (replicated_input,
                                                 replicated_output)
from agcn_tpu_torch.parallel.mesh import Mesh

COMBINERS = ("psum", "ppermute")


def partitioned_adjacency(adj: np.ndarray, num_parts: int) -> np.ndarray:
    """Split a (K, V, V) adjacency stack into per-rank masked stacks.

    Returns (num_parts, K, V, V): part p holds only its edge slice of each
    subset; summing over parts recovers the full adjacency.
    """
    k, v, _ = adj.shape
    out = np.zeros((num_parts, k, v, v), dtype=adj.dtype)
    for ki in range(k):
        for p, es in enumerate(dense_to_edges(adj[ki]).partition(num_parts)):
            out[p, ki] = es.to_dense()
    return out


def local_aggregate(x: torch.Tensor, local_adj: torch.Tensor) -> torch.Tensor:
    """Aggregate the locally-owned edges: (B, T, V, C) x (K, V, V) ->
    (K, B, T, V, C) partial destination features."""
    return torch.einsum("btvc,kvw->kbtwc", x, local_adj)


def _edge_axis(mesh: Mesh):
    return mesh.group("edge"), mesh.coordinate("edge"), mesh.shape["edge"]


def _check_combiner(combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"combiner {combiner!r}: one of {COMBINERS}")


def edge_partitioned_aggregate(x: torch.Tensor, adj: np.ndarray, mesh: Mesh,
                               combiner: str = "psum") -> torch.Tensor:
    """Full K-subset aggregation with the edges partitioned over the
    mesh's 'edge' axis.

    Args:
      x: (B, T, V, C), the same on every edge rank.
      adj: full (K, V, V) stack (host numpy).
      mesh: a mesh with an 'edge' axis.
      combiner: 'psum' | 'ppermute'.
    Returns:
      (K, B, T, V, C) aggregated features, the same on every edge rank.
    """
    _check_combiner(combiner)
    group, d, n_edge = _edge_axis(mesh)
    local = torch.as_tensor(partitioned_adjacency(adj, n_edge)[d],
                            device=x.device, dtype=x.dtype)
    partial = local_aggregate(replicated_input(x, group), local)
    return replicated_output(partial, group, combiner)


def make_edge_partitioned_gcn(adj: np.ndarray, mesh: Mesh,
                              combiner: str = "psum"
                              ) -> Tuple[Callable, torch.Tensor]:
    """Build y = sum_k (x @ A_k) @ W_k with edge-sharded aggregation.

    Returns (fn, parts): fn(x (B,T,V,C), parts, weights (K,Cin,Cout)) ->
    (B,T,V,Cout), `parts` the (P, K, V, V) partitioned stack of which
    each rank takes its own. The projection happens on the partial
    (local-edge) features before the combine, so the collective moves
    Cout-sized activations.
    """
    _check_combiner(combiner)
    group, d, n_edge = _edge_axis(mesh)
    parts = torch.as_tensor(partitioned_adjacency(adj, n_edge))

    def run(x: torch.Tensor, adj_parts: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
        local = adj_parts[d].to(x.device, x.dtype)
        partial = local_aggregate(replicated_input(x, group), local)
        z = torch.einsum("kbtwc,kco->btwo", partial,
                         replicated_input(weights, group))
        return replicated_output(z, group, combiner)

    return run, parts


def make_hybrid_partitioned_gcn(adj: np.ndarray, mesh: Mesh
                                ) -> Tuple[Callable, torch.Tensor]:
    """Subset x output-channel hybrid partitioning with real work division.

    The 'edge' axis is split into (subset, output) factors chosen to
    minimize the padded work of a rank, ceil(K/ks)/K * 1/os (the JAX
    package's choice), and the two einsums run project-first (x @ W
    commutes with the aggregation), so both the projection and the V x V
    aggregation carry only the rank's (subset, output-chunk) share. Each
    rank places its slice at its channel offset and one all-reduce sums
    the subset factor and assembles the output factor.

    Returns (fn, parts) with fn(x (B,T,V,C), parts, w (K,C,Co)) ->
    (B,T,V,Co); parts[d] is rank d's subsets.
    """
    p = mesh.shape["edge"]
    group, d, _ = _edge_axis(mesh)
    k, v, _ = adj.shape
    best = None
    for ks in (c for c in range(1, p + 1) if p % c == 0 and c <= k):
        os_c = p // ks
        per_c = -(-k // ks)
        ratio = per_c / k / os_c
        if best is None or ratio < best[0]:
            best = (ratio, ks, os_c, per_c)
    _, ks, os_, per = best
    k_pad = ks * per - k
    adj_padded = np.concatenate(
        [adj, np.zeros((k_pad, v, v), adj.dtype)]) if k_pad else adj
    # rank d = (s, o): owns subsets [s*per, (s+1)*per)
    parts = torch.as_tensor(np.stack([adj_padded[s * per:(s + 1) * per]
                                      for s in range(ks)
                                      for _ in range(os_)]))
    s, o = d // os_, d % os_

    def run(x: torch.Tensor, adj_parts: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
        co = w.shape[-1]
        co_pad = -co % os_  # pad channels so every rank gets a chunk
        chunk = (co + co_pad) // os_
        w = F.pad(replicated_input(w, group), (0, co_pad, 0, 0, 0, k_pad))
        # my subset slice of the weights, my output-channel slice
        w_local = w[s * per:(s + 1) * per, :, o * chunk:(o + 1) * chunk]
        proj = torch.einsum("btvc,kco->kbtvo", replicated_input(x, group),
                            w_local)
        z = torch.einsum("kbtvo,kvw->btwo", proj,
                         adj_parts[d].to(x.device, x.dtype))
        # my output slice at its channel offset; slices are disjoint
        # across the output factor and summed across the subset factor
        full = F.pad(z, (o * chunk, co + co_pad - (o + 1) * chunk))
        return replicated_output(full, group)[..., :co]

    return run, parts


def model_edge_gcn(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """In-model edge-partitioned adaptive GCN, y = sum_k (x @ A1_k) @ W_k
    with the K subsets partitioned across the 'edge' axis (each rank owns
    ceil(K/P) of them, K zero-padded to a multiple of P) and the partials
    combined by a reduce-scatter over P time chunks and an all-gather (T
    zero-padded to a multiple of P, the pad sliced off after).

    Args:
      x: (B, T, V, C), the same on every edge rank.
      a1: (B, K, V, V) combined data-dependent adjacency (the same).
      w: (K, C, Co) per-subset projection kernels (the same).
      mesh: a mesh with an 'edge' axis of size P.
    Returns:
      (B, T, V, Co), the same on every edge rank; ops.gcn.apply_gcn(x, a1,
      w) up to the summation order. Differentiable in x, a1 and w.
    """
    p = mesh.shape["edge"]
    if p == 1:
        partial = torch.einsum("btvc,bkvw->kbtwc", x, a1)
        return torch.einsum("kbtwc,kco->btwo", partial, w)
    group, d, _ = _edge_axis(mesh)
    k = a1.shape[1]
    k_pad = -k % p
    per = (k + k_pad) // p
    t_in = x.shape[1]
    t_pad = -t_in % p
    x = F.pad(replicated_input(x, group), (0, 0, 0, 0, 0, t_pad))
    a1 = F.pad(replicated_input(a1, group), (0, 0, 0, 0, 0, k_pad))
    w = F.pad(replicated_input(w, group), (0, 0, 0, 0, 0, k_pad))
    agg = torch.einsum("btvc,bkvw->kbtwc", x, a1[:, d * per:(d + 1) * per])
    part = torch.einsum("kbtwc,kco->btwo", agg, w[d * per:(d + 1) * per])
    out = replicated_output(part, group, "chunked")
    return out[:, :t_in] if t_pad else out
