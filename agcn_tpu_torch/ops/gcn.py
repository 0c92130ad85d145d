"""Graph-convolution compute primitives, channels-last
(port of agcn_tpu/ops/gcn.py, the forms ported so far). Autograd of
'agg' and 'agg_packed' is torch's own; the pallas forms carry their own
backward (ops/kernels/gcn_fused.py).

  aggregate-and-project: y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] * a1[b,k,v,w]
                                                  * W[k,c,o]
  attention logits:      S[b,k,v,w] = sum_{t,c} th_k[b,t,v,c]
                                                 * ph_k[b,t,w,c] / (Ce*T)

Layouts are the JAX package's: x (B, T, V, C), a1 (B, K, V, V) with
a1[b, k, source, dest], W (K, C, Co). Every `apply_gcn` form of the JAX
package is here (agcn_tpu ops/gcn.py:160-331). The forms other than
'pallas' are XLA einsum orders there, not Pallas kernels, so here they are
torch's matmuls and einsums; 'custom' is project-first with the
hand-ordered backward of `adaptive_gcn_bwd` (the JAX `custom_vjp`).

SGN's per-frame graph step (`frame_attention`, `frame_aggregate`,
ops/gcn.py:60-87) is a pair of batched einsums on cuBLAS: the JAX package
gives it no Pallas kernel either. So are the plain graph primitives
`aggregate` (y = x @ A over the joints, for a static, per-sample or
per-frame A) and `embedding_attention` (ops/gcn.py:24-57), which no model
calls.
"""

from __future__ import annotations

import torch


def aggregate(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Graph aggregation y = x @ A over the joint axis (agcn_tpu
    ops/gcn.py:24-40).

    Args:
      x: (..., V, C) joint features (typically (B, T, V, C)).
      adj: (V, V) static, (B, V, V) per-sample, or (B, T, V, V) per-frame
        adjacency with A[source, dest] layout.
    Returns:
      Same shape as x, with joint axis aggregated.
    """
    if adj.dim() == 2:
        return einsum("...vc,vw->...wc", x, adj)
    if adj.dim() == 3:
        return einsum("btvc,bvw->btwc", x, adj)
    if adj.dim() == 4:
        return einsum("btvc,btvw->btwc", x, adj)
    raise ValueError(f"bad adjacency rank {adj.dim()}")


def embedding_attention(theta: torch.Tensor,
                        phi: torch.Tensor) -> torch.Tensor:
    """Per-sample data-dependent adjacency C = softmax(theta^T phi / d)
    (agcn_tpu ops/gcn.py:43-57): the contraction over (time, channel)
    jointly, divided by Ce * T, and the softmax over the *source* joint
    axis (reference agcn.py:99-101, softmax dim=-2).

    Args:
      theta, phi: (B, T, V, Ce) embedded features.
    Returns:
      (B, V, V) attention adjacency, columns summing to 1.
    """
    _, t, _, ce = theta.shape
    logits = einsum("btvc,btwc->bvw", theta, phi) / (ce * t)
    return torch.softmax(logits, dim=-2)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """p[b,t,v,k,o] = x ·_c W_k: one wide (B*T*V, C) x (C, K*Co) GEMM."""
    b, t, v, c = x.shape
    k, _, co = w.shape
    return (x @ w.permute(1, 0, 2).reshape(c, k * co)).reshape(
        b, t, v, k, co)


def _aggregate_packed(x: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """z[b,t,c,k,w] = x ·_v a1_k as one (T*C, V) x (V, K*V) batched
    matmul ('agg_packed''s aggregation)."""
    b, t, v, c = x.shape
    k = a1.shape[1]
    x2 = x.permute(0, 1, 3, 2).reshape(b, t * c, v)
    a2 = a1.permute(0, 2, 1, 3).reshape(b, v, k * v)
    return torch.bmm(x2, a2).reshape(b, t, c, k, v)


def _project_first(x: torch.Tensor, a1: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Project-first ('pf', agcn_tpu ops/gcn.py:123-128): the wide GEMM,
    then the joint (k, v) contraction."""
    return einsum("btvko,bkvw->btwo", _project(x, w), a1)


class _AdaptiveGCN(torch.autograd.Function):
    """'custom': the project-first forward with the backward of
    `adaptive_gcn_bwd`, each cotangent in its own einsum order
    (agcn_tpu ops/gcn.py:91-148, a `jax.custom_vjp`)."""

    @staticmethod
    def forward(ctx, x, a1, w):
        ctx.save_for_backward(x, a1, w)
        return _project_first(x, a1, w)

    @staticmethod
    def backward(ctx, g):
        x, a1, w = ctx.saved_tensors
        dx, da1, dw = adaptive_gcn_bwd(x, a1, w, g)
        return dx.to(x.dtype), da1.to(a1.dtype), dw.to(w.dtype)


def adaptive_gcn(x: torch.Tensor, a1: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] w[k,c,o] a1[b,k,v,w],
    project-first with the hand-ordered backward ('custom')."""
    return _AdaptiveGCN.apply(x, a1, w)


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
    z = _aggregate_packed(x, a1)
    z = z.permute(0, 1, 4, 3, 2).reshape(b, t, v, k * c)
    return z @ w.reshape(k * c, -1)


def adaptive_gcn_pf_packed(x: torch.Tensor, a1: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Project-first with (k, v) packed as one contraction axis
    ('pf_packed', ops/gcn.py:160-170)."""
    b, t, v, c = x.shape
    k, _, co = w.shape
    p2 = _project(x, w).permute(0, 1, 4, 3, 2).reshape(b, t * co, k * v)
    y = einsum("bmx,bxw->bmw", p2, a1.reshape(b, k * v, v))
    return y.reshape(b, t, co, v).permute(0, 1, 3, 2)


def adaptive_gcn_agg_packed2(x: torch.Tensor, a1: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """'agg_packed' with the contracted V second on both operands
    ('agg_packed2', ops/gcn.py:186-196)."""
    b, t, v, c = x.shape
    k = a1.shape[1]
    x2 = x.permute(0, 2, 1, 3).reshape(b, v, t * c)
    a2 = a1.permute(0, 2, 1, 3).reshape(b, v, k * v)
    z = torch.bmm(x2.transpose(1, 2), a2).reshape(b, t, c, k, v)
    z = z.permute(0, 1, 4, 3, 2).reshape(b, t, v, k * c)
    return z @ w.reshape(k * c, -1)


def adaptive_gcn_agg_dp(x: torch.Tensor, a1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The 'agg_packed' aggregation, then a projection that contracts the
    packed (c, k) axes directly ('agg_dp', ops/gcn.py:199-210)."""
    return einsum("btckv,kco->btvo", _aggregate_packed(x, a1), w)


def adaptive_gcn_fused_dyn(x: torch.Tensor, a1: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """The K-subset aggregate-and-project as one per-sample (V*C, V*Co)
    operator, M[b][(v,c),(w,o)] = sum_k a1[b,k,v,w] w[k,c,o]
    ('fused_dyn', ops/gcn.py:261-280)."""
    b, t, v, c = x.shape
    k, _, co = w.shape
    op = einsum("bkvw,kco->bvcwo", a1, w).reshape(b, v * c, v * co)
    y = einsum("btm,bmn->btn", x.reshape(b, t, v * c), op)
    return y.reshape(b, t, v, co)


# 'hybrid': fused_dyn while its per-sample operator has at most this many
# entries, else agg_packed (ops/gcn.py:281-283)
FUSED_DYN_MAX_OPERATOR = 1600 * 1600


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
    p = _project(x, w)  # recomputed: one wide GEMM
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


def frame_attention(g1: torch.Tensor, g2: torch.Tensor,
                    activation: str = "softmax") -> torch.Tensor:
    """Per-frame dense attention G = act(g1 g2^T) (SGN; agcn_tpu
    ops/gcn.py:60-78, reference sgn blocks/spatial.py:230-240): for each
    frame t, G[t] = softmax_w(g1[t] @ g2[t]^T), a softmax over the *last*
    axis.

    Args:
      g1, g2: (B, T, V, Ce).
    Returns:
      (B, T, V, V) attention, G[b,t,v,w] = weight of source w for dest v.
    """
    logits = torch.einsum("btvc,btwc->btvw", g1, g2)
    if activation == "softmax":
        return torch.softmax(logits, dim=-1)
    if activation == "sigmoid":
        return torch.sigmoid(logits)
    if activation == "identity":
        return logits
    raise ValueError(f"unknown activation {activation!r}")


def frame_aggregate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """SGN's per-frame aggregation x2[b,t,v,:] = sum_w G[b,t,v,w] x[b,t,w,:]
    (agcn_tpu ops/gcn.py:81-87): the destination is the row of G."""
    return torch.matmul(g, x)


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
    """Dispatch between GCN formulations, each the same function
    (agcn_tpu ops/gcn.py:286-331). 'pallas' and 'pallas_hybrid'
    run the fused Hopper kernel at every C, the C=3 entry layer included
    (the JAX package routes C < 8 to 'agg_packed' because Mosaic cannot
    lay out a minor dim of 3; the result is the same function). 'hybrid'
    is 'fused_dyn' while (V*C)*(V*Co) <= FUSED_DYN_MAX_OPERATOR, else
    'agg_packed'."""
    if formulation == "hybrid":
        v, c, co = x.shape[-2], x.shape[-1], w.shape[-1]
        formulation = ("fused_dyn" if (v * c) * (v * co)
                       <= FUSED_DYN_MAX_OPERATOR else "agg_packed")
    forms = {"pf": _project_first, "custom": adaptive_gcn,
             "agg": adaptive_gcn_reference,
             "pf_packed": adaptive_gcn_pf_packed,
             "agg_packed": adaptive_gcn_agg_packed,
             "agg_packed2": adaptive_gcn_agg_packed2,
             "agg_dp": adaptive_gcn_agg_dp,
             "fused_dyn": adaptive_gcn_fused_dyn}
    if formulation in forms:
        return forms[formulation](x, a1, w)
    if formulation in ("pallas", "pallas_hybrid"):
        from agcn_tpu_torch.ops.kernels import gcn_fused

        fn = (gcn_fused.adaptive_gcn_pallas if formulation == "pallas"
              else gcn_fused.adaptive_gcn_pallas_hybrid)
        return fn(x, a1, w)
    raise ValueError(f"unknown GCN formulation {formulation!r}")
