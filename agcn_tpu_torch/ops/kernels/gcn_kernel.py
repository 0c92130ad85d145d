"""`fused_gcn`: the fused adaptive graph convolution with an fp32
aggregate (port of agcn_tpu/ops/pallas/gcn_kernel.py).

  z[b,t,w,o] = sum_k sum_v sum_c a1[b,k,v,w] * x[b,t,v,c] * W[k,c,o]

The TPU kernel works on joint-major (B, V, T, C) blocks and keeps the
three subsets' aggregates in fp32 for one (V*Tt, 3C) @ (3C, Co)
projection. Here it runs on the same Hopper kernel as `gcn_fused`
(`csrc/gcn_fwd.cu`) with `round_agg=False`, in the model's own
(B, T, V, C) layout: no host transpose, no padded time tiles.
"""

from __future__ import annotations

import torch

from agcn_tpu_torch.ops.kernels.gcn_fused import gcn_forward


def fused_gcn(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
              time_tile: int = 64) -> torch.Tensor:
    """z = sum_k (x @ a1_k) @ W_k with a per-sample (B, K, V, V) adjacency.

    Args:
      x: (B, T, V, C) features.
      a1: (B, K, V, V) combined adjacency, a1[b, k, source, dest].
      w: (K, C, Co) per-subset projection kernels.
      time_tile: kept for the JAX signature; the Hopper kernel picks its
        own tile of 4 frames and masks the ragged edge.
    """
    if time_tile < 1:
        raise ValueError(f"time_tile must be positive, got {time_tile}")
    z, launched = gcn_forward("fused_gcn", x, a1, w, False)
    if launched:
        fused_gcn.launches += 1
    return z


fused_gcn.launches = 0


def reference_fused_gcn(x: torch.Tensor, a1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Einsum reference, for validation."""
    agg = torch.einsum("btvc,bkvw->btwkc", x, a1)
    return torch.einsum("btwkc,kco->btwo", agg, w)
