"""Graph-convolution compute primitives, channels-last
(port of agcn_tpu/ops/gcn.py, the forms ported so far). Autograd of
'agg' and 'agg_packed' is torch's own; the pallas forms carry their own
backward (ops/kernels/gcn_fused.py).

  aggregate-and-project: y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] * a1[b,k,v,w]
                                                  * W[k,c,o]
  attention logits:      S[b,k,v,w] = sum_{t,c} th_k[b,t,v,c]
                                                 * ph_k[b,t,w,c] / (Ce*T)

Layouts are the JAX package's: x (B, T, V, C), a1 (B, K, V, V) with
a1[b, k, source, dest], W (K, C, Co). The other `apply_gcn` forms wait
(ROADMAP, Queue 1).
"""

from __future__ import annotations

import torch


def adaptive_gcn_reference(x: torch.Tensor, a1: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Aggregate-then-project ('agg', agcn_tpu ops/gcn.py:151-157)."""
    b, t, v, c = x.shape
    k = a1.shape[1]
    agg = torch.einsum("btvc,bkvw->btwkc", x, a1).reshape(b, t, v, k * c)
    return agg @ w.reshape(k * c, -1)


def adaptive_gcn_agg_packed(x: torch.Tensor, a1: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Aggregate-then-project with the aggregation as one (T*C, V) x
    (V, K*V) batched matmul ('agg_packed', ops/gcn.py:173-183)."""
    b, t, v, c = x.shape
    k = a1.shape[1]
    x2 = x.permute(0, 1, 3, 2).reshape(b, t * c, v)
    a2 = a1.permute(0, 2, 1, 3).reshape(b, v, k * v)
    z = torch.bmm(x2, a2).reshape(b, t, c, k, v)  # (B, T*C, K*V)
    z = z.permute(0, 1, 4, 3, 2).reshape(b, t, v, k * c)
    return z @ w.reshape(k * c, -1)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` with JAX's type promotion (torch's einsum takes one
    dtype only): the operands are cast to their common type."""
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    return torch.einsum(eq, *(op.to(dtype) for op in operands))


def adaptive_gcn_bwd(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                     g: torch.Tensor):
    """(dx, da1, dW) of y = sum_k (x @_v a1_k) @_c W_k for the cotangent
    g, each in the einsum order with the largest contractions
    (agcn_tpu ops/gcn.py:130-145, the `pallas_hybrid` backward)."""
    b, t, v, c = x.shape
    k, _, co = w.shape
    wc = w.permute(1, 0, 2).reshape(c, k * co)
    p = (x @ wc).reshape(b, t, v, k, co)  # recomputed: one wide GEMM
    da1 = einsum("btvko,btwo->bkvw", p, g)
    u = einsum("btwo,kco->btwkc", g, w)
    dx = einsum("btwkc,bkvw->btvc", u, a1)
    agg = einsum("btvc,bkvw->btwkc", x, a1)
    dw = einsum("btwkc,btwo->kco", agg, g)
    return dx, da1, dw


def attention_logits(emb: torch.Tensor, num_subset: int, inter_c: int,
                     form: str = "transposed") -> torch.Tensor:
    """Per-subset embedding-attention logits from the fused theta|phi
    embedding output (divisor Ce * T; softmax applied by the caller).
    The forms are one function summed in other orders and layouts
    (agcn_tpu ops/gcn.py:213-258); the models run 'transposed'.

    Args:
      emb: (B, T, V, 2*K*Ce) — [theta_0..theta_{K-1}, phi_0..phi_{K-1}].
    Returns:
      (B, K, V, V) scaled logits.
    """
    b, t, v, _ = emb.shape
    k, ce = num_subset, inter_c
    e = emb.reshape(b, t, v, 2, k, ce)
    theta, phi = e[..., 0, :, :], e[..., 1, :, :]
    if form == "transposed":
        # pack (T, Ce) per (B, K) batch element
        th = theta.permute(0, 3, 2, 1, 4).reshape(b, k, v, t * ce)
        ph = phi.permute(0, 3, 2, 1, 4).reshape(b, k, v, t * ce)
    elif form == "transposed_tl":
        # pack (Ce, T) instead of (T, Ce)
        th = theta.permute(0, 3, 2, 4, 1).reshape(b, k, v, ce * t)
        ph = phi.permute(0, 3, 2, 4, 1).reshape(b, k, v, ce * t)
    elif form == "onepack":
        # one transpose of the combined tensor
        e2 = e.permute(0, 3, 4, 2, 1, 5).reshape(b, 2, k, v, t * ce)
        th, ph = e2[:, 0], e2[:, 1]
    elif form == "blockdiag":
        # one (K*V, K*V) bilinear product, then its K diagonal blocks
        e2 = e.permute(0, 3, 4, 2, 1, 5).reshape(b, 2, k * v, t * ce)
        big = torch.matmul(e2[:, 0], e2[:, 1].transpose(-1, -2))
        return torch.einsum("bkvkw->bkvw",
                            big.reshape(b, k, v, k, v)) / (ce * t)
    elif form == "naive":
        return torch.einsum("btvkc,btwkc->bkvw", theta, phi) / (ce * t)
    else:
        raise ValueError(f"unknown attention form {form!r}")
    return torch.matmul(th, ph.transpose(-1, -2)) / (ce * t)


def fused_static_operator(adj: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Fold K-subset aggregation + per-subset projections into one
    (V*Cin, V*Cout) operator (agcn_tpu ops/gcn.py:334-351):
    M[(v,ci),(w,co)] = sum_k A_k[v,w] * W_k[ci,co].

    Args:
      adj: (K, V, V).
      weights: (K, Cin, Cout).
    """
    k, v, _ = adj.shape
    _, ci, co = weights.shape
    return einsum("kvw,kio->viwo", adj, weights).reshape(v * ci, v * co)


def apply_fused_static(x: torch.Tensor, operator: torch.Tensor,
                       num_joints: int) -> torch.Tensor:
    """Apply a fused (V*Cin, V*Cout) operator to (..., V, Cin) features."""
    *lead, v, ci = x.shape
    y = x.reshape(*lead, v * ci) @ operator
    return y.reshape(*lead, num_joints, -1)


def apply_gcn(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
              formulation: str = "agg") -> torch.Tensor:
    """Dispatch between GCN formulations. 'pallas' and 'pallas_hybrid'
    run the fused Hopper kernel at every C, the C=3 entry layer included
    (the JAX package routes C < 8 to 'agg_packed' because Mosaic cannot
    lay out a minor dim of 3; the result is the same function)."""
    if formulation == "agg":
        return adaptive_gcn_reference(x, a1, w)
    if formulation == "agg_packed":
        return adaptive_gcn_agg_packed(x, a1, w)
    if formulation in ("pallas", "pallas_hybrid"):
        from agcn_tpu_torch.ops.kernels import gcn_fused

        fn = (gcn_fused.adaptive_gcn_pallas if formulation == "pallas"
              else gcn_fused.adaptive_gcn_pallas_hybrid)
        return fn(x, a1, w)
    if formulation in ("pf", "custom", "pf_packed", "agg_packed2", "agg_dp",
                       "fused_dyn", "hybrid"):
        raise NotImplementedError(
            f"GCN formulation {formulation!r} is not ported yet "
            "(ROADMAP, Queue 1)")
    raise ValueError(f"unknown GCN formulation {formulation!r}")
