"""`fused_gcn`: the fused adaptive graph convolution with an fp32
aggregate (port of agcn_tpu/ops/pallas/gcn_kernel.py).

  z[b,t,w,o] = sum_k sum_v sum_c a1[b,k,v,w] * x[b,t,v,c] * W[k,c,o]

The TPU kernel works on joint-major (B, V, T, C) blocks and keeps the
three subsets' aggregates in fp32 for one (V*Tt, 3C) @ (3C, Co)
projection. Here it runs on the same Hopper kernels as `gcn_fused`
(`csrc/gcn_fwd.cu`) with `round_agg=False`, in the model's own
(B, T, V, C) layout: no host transpose, no padded time tiles. In bf16
that is `gcn_fwd_mma_kernel` on the tensor cores, with each fp32
aggregate projected as two bf16 parts (hi + lo, within 2^-16 of it);
in fp32 `gcn_fwd_fp32_kernel` on the CUDA cores. Its
backward is the JAX package's einsum `_bwd` (gcn_kernel.py:107-117): the
TPU package has no backward kernel here, so neither has the port.
"""

from __future__ import annotations

import torch

from agcn_tpu_torch.ops.gcn import einsum
from agcn_tpu_torch.ops.kernels.gcn_fused import gcn_forward, needs_grad


def _forward(x: torch.Tensor, a1: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    z, launched = gcn_forward("fused_gcn", x, a1, w, False)
    if launched:
        fused_gcn.launches += 1
    return z


class _FusedGCN(torch.autograd.Function):
    """The JAX `_fwd` / `_bwd` pair (gcn_kernel.py:103-117)."""

    @staticmethod
    def forward(ctx, x, a1, w):
        ctx.save_for_backward(x, a1, w)
        return _forward(x, a1, w)

    @staticmethod
    def backward(ctx, g):
        x, a1, w = ctx.saved_tensors
        # dz/dx: route g back through W^T then the transposed adjacency
        gw = einsum("btwo,kco->btwkc", g, w)
        dx = einsum("btwkc,bkvw->btvc", gw, a1)
        da1 = einsum("btvc,btwkc->bkvw", x, gw)
        agg = einsum("btvc,bkvw->btwkc", x, a1)
        dw = einsum("btwkc,btwo->kco", agg, g)
        return dx.to(x.dtype), da1.to(a1.dtype), dw.to(w.dtype)


def fused_gcn(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
              time_tile: int = 64) -> torch.Tensor:
    """z = sum_k (x @ a1_k) @ W_k with a per-sample (B, K, V, V) adjacency.

    Args:
      x: (B, T, V, C) features.
      a1: (B, K, V, V) combined adjacency, a1[b, k, source, dest].
      w: (K, C, Co) per-subset projection kernels.
      time_tile: kept for the JAX signature; the Hopper kernel picks its
        own frame tile and masks the ragged edge.
    """
    if time_tile < 1:
        raise ValueError(f"time_tile must be positive, got {time_tile}")
    if needs_grad(x, a1, w):
        return _FusedGCN.apply(x, a1, w)
    return _forward(x, a1, w)


fused_gcn.launches = 0


def reference_fused_gcn(x: torch.Tensor, a1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Einsum reference, for validation."""
    agg = torch.einsum("btvc,bkvw->btwkc", x, a1)
    return torch.einsum("btwkc,kco->btwo", agg, w)
