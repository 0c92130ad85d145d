"""Differentiable collectives over one process group (an axis of the mesh).

The port's counterparts of the JAX collectives that `shard_map` and
GSPMD emit (agcn_tpu/parallel/edge_partition.py, agcn_tpu/ops/norm.py):

- `psum`: all-reduce forward, all-reduce backward (JAX's psum, whose
  transpose is a psum): the SyncBN statistics.
- `replicated_input`: identity forward, all-reduce backward. A tensor
  replicated over the group that each rank uses for its own share of the
  work: the shares of its gradient are summed.
- `replicated_output`: the ranks' partials combined forward (all-reduce,
  ring, or reduce-scatter then all-gather over time chunks), identity
  backward. Its gradient is whole on every rank already.

A `None` group is a one-rank axis without a process group: every
collective is the identity there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

COMBINERS = ("psum", "ppermute", "chunked")
# torch >= 2.13 names them *_single; the *_tensor names stay as aliases
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def ring_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group by P - 1 ring hops: each rank sends its
    buffer to the next and adds the one from the previous (JAX's
    ppermute ring, edge_partition.py:76-84)."""
    if group is None or dist.get_world_size(group) == 1:
        return t.clone()
    p = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % p)
    prv = dist.get_global_rank(group, (me - 1) % p)
    acc = t.contiguous().clone()
    buf = acc.clone()
    for _ in range(p - 1):
        recv = torch.empty_like(buf)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for w in works:
            w.wait()
        buf = recv
        acc = acc + buf
    return acc


def chunked_sum(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The sum over the group as a reduce-scatter of `dim`'s P chunks,
    then an all-gather of the reduced chunks (the two phases of JAX's
    time-chunked ring, edge_partition.py:241-262). `dim` must divide by
    P."""
    if group is None or dist.get_world_size(group) == 1:
        return t.clone()
    p = dist.get_world_size(group)
    chunks = torch.stack(t.chunk(p, dim=dim))  # (P, ..., T/P, ...)
    mine = torch.empty_like(chunks[:1])
    _reduce_scatter(mine, chunks, group=group)
    gathered = torch.empty_like(chunks)
    _all_gather(gathered, mine, group=group)
    return torch.cat(gathered.unbind(0), dim=dim)


def _combine(t: torch.Tensor, group, combiner: str) -> torch.Tensor:
    if combiner == "psum":
        return _all_reduce(t, group)
    if combiner == "ppermute":
        return ring_sum(t, group)
    if combiner == "chunked":
        return chunked_sum(t, group)
    raise ValueError(f"combiner {combiner!r}: one of {COMBINERS}")


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, combiner):
        return _combine(t, group, combiner)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of `t` over the group; its backward sums the gradient over
    the group too (JAX's psum)."""
    return _Psum.apply(t, group)


def replicated_input(t: torch.Tensor, group: Optional[object]
                     ) -> torch.Tensor:
    """`t` itself; in the backward, the sum of the ranks' gradients."""
    return _ReplicatedInput.apply(t, group)


def replicated_output(t: torch.Tensor, group: Optional[object],
                      combiner: str = "psum") -> torch.Tensor:
    """The sum of the ranks' partials `t` by `combiner` ('psum': one
    all-reduce, 'ppermute': a ring of sends, 'chunked': reduce-scatter
    and all-gather over dim 1); the gradient passes through unchanged."""
    return _ReplicatedOutput.apply(t, group, combiner)
