"""Fused adaptive graph convolution forward on a hand-written Hopper
kernel (port of agcn_tpu/ops/pallas/gcn_fused.py).

  y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] * a1[b,k,v,w] * W[k,c,o]

`csrc/gcn_fwd.cu` computes it per (sample, 4 frames, 64 output channels)
block with the per-subset aggregate kept in shared memory, never in
device memory. One kernel serves both TPU forward kernels of the JAX
package; a flag picks the one real numerical difference between them in
bf16: `round_agg=True` rounds each per-subset aggregate to x's type
before the projection (gcn_fused.py:58-60), `round_agg=False` keeps it in
fp32 (gcn_kernel.py:45-49). The projection accumulates in fp32 over c and
k; y comes out in x's type.

The TPU layout artefacts are not carried over: no zero-padding of the
contractions to 128, no time tiles in multiples of 8 with T padded up,
no routing of C < 8 elsewhere — the kernel masks its ragged edges and
runs the C=3 entry layer too.

`gcn_fwd_plain` is the same function in plain PyTorch, with the same
rounding flag. A wrapper takes it only for CPU tensors; for CUDA tensors
it launches the kernel or raises. The backward kernel lands with the
training slice: until then a call that autograd would have to
differentiate raises.
"""

from __future__ import annotations

import ctypes

import torch

from agcn_tpu_torch.ops.kernels import build

K = 3  # subset count is structural in this architecture (reference A/B/C)
SUPPORTED_JOINTS = (18, 25)  # V of the AGCN skeletons (Kinetics, NTU)


def gcn_fwd_plain(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                  round_agg: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per subset, the aggregate in
    fp32 (rounded to x's type when `round_agg`), projected and summed in
    fp32; the result in x's type."""
    xf = x.float()
    acc = None
    for k in range(a1.shape[1]):
        agg = torch.einsum("btvc,bvw->btwc", xf, a1[:, k].float())
        if round_agg:
            agg = agg.to(x.dtype).float()
        y = agg @ w[k].float()
        acc = y if acc is None else acc + y
    return acc.to(x.dtype)


def _forbid_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward yet: the backward kernel lands with "
            "the training slice. Call it under torch.no_grad() or "
            "torch.inference_mode().")


def _check(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if a1.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"a1 must be float32 or x's dtype, got {a1.dtype}")
    if x.dim() != 4 or a1.dim() != 4 or w.dim() != 3:
        raise ValueError("expected x (B,T,V,C), a1 (B,K,V,V), w (K,C,Co); "
                         f"got {tuple(x.shape)}, {tuple(a1.shape)}, "
                         f"{tuple(w.shape)}")
    b, _, v, c = x.shape
    if tuple(a1.shape) != (b, K, v, v) or tuple(w.shape[:2]) != (K, c):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"a1 {tuple(a1.shape)}, w {tuple(w.shape)}")
    if v not in SUPPORTED_JOINTS:
        raise ValueError(f"V={v} joints: the kernel is built for "
                         f"{SUPPORTED_JOINTS}")
    if not (x.is_contiguous() and a1.is_contiguous() and w.is_contiguous()):
        raise ValueError("x, a1 and w must be contiguous")


def launch_gcn_fwd(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                   round_agg: bool) -> torch.Tensor:
    """Launch `csrc/gcn_fwd.cu` on the current stream (CUDA tensors)."""
    _check(x, a1, w)
    b, t, v, c = x.shape
    co = w.shape[-1]
    y = torch.empty((b, t, v, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = build.load("gcn_fwd").agcn_gcn_fwd
    if fn.argtypes is None:
        # without argtypes ctypes passes each int as a 32-bit C int and
        # cuts the pointers
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    # the C entry launches on the current device: make it x's for the
    # call, and leave the caller's current device as it was
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), a1.data_ptr(), w.data_ptr(), y.data_ptr(),
                 b, t, v, c, co, int(x.dtype == torch.bfloat16),
                 int(a1.dtype == torch.bfloat16), int(round_agg),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"gcn_fwd kernel launch failed: CUDA error {err}")
    return y


def gcn_forward(name: str, x: torch.Tensor, a1: torch.Tensor,
                w: torch.Tensor, round_agg: bool):
    """Dispatch on where the tensors lie: CPU -> plain version, CUDA ->
    the kernel. Returns (y, launched)."""
    _forbid_grad(name, x, a1, w)
    devices = {x.device, a1.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    kind = x.device.type
    if kind == "cpu":
        return gcn_fwd_plain(x, a1, w, round_agg), False
    if kind == "cuda":
        return launch_gcn_fwd(x, a1, w, round_agg), True
    raise ValueError(f"{name}: unsupported device {x.device}")


def adaptive_gcn_pallas(x: torch.Tensor, a1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Fused y = sum_k (x @_v a1_k) @_c W_k with the aggregate rounded to
    x's type (the gcn_fused semantics).

    Args:
      x: (B, T, V, C) features (bf16 or f32).
      a1: (B, K, V, V) combined adjacency, a1[b,k,source,dest].
      w: (K, C, Co) per-subset projection kernels.
    Returns:
      (B, T, V, Co) in x.dtype.
    """
    y, launched = gcn_forward("adaptive_gcn_pallas", x, a1, w, True)
    if launched:
        adaptive_gcn_pallas.launches += 1
    return y


adaptive_gcn_pallas.launches = 0


def adaptive_gcn_pallas_hybrid(x: torch.Tensor, a1: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """The same kernel forward; the JAX form differs from
    `adaptive_gcn_pallas` only in its backward (einsum cotangents), which
    lands with the training slice."""
    return adaptive_gcn_pallas(x, a1, w)
