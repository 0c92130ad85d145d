"""Embedding-attention logits on a hand-written Hopper kernel
(port of agcn_tpu/ops/pallas/logits_kernel.py).

  S[b,k,v,w] = sum_{t,c} theta[b,t,v,k,c] * phi[b,t,w,k,c] / divisor

`attention_logits_pallas(theta, phi, divisor)` is the entry point, with
the JAX signature: theta and phi (B, T, V, K, Ce) in fp32 or bf16, the
logits (B, K, V, V) in fp32, the sums in fp32. On CUDA tensors it
launches `csrc/logits.cu`, which computes only the K diagonal V x V
blocks that the TPU kernel cuts out of its 128 x 128 packed product, and
reads theta and phi through their strides: the theta/phi views of the
fused (B, T, V, 2*K*Ce) embedding need no copy. The contraction is split
into a number of spans fixed by the shapes (enough blocks for the card at
a served batch) and the spans' partials are summed in a fixed order, so
two calls give bitwise-equal results. Like the TPU kernel it has no
backward.

`pack_rows`, `pack_cols`, `packed_logits_plain` and
`attention_logits_plain` are the JAX package's packed formulation in
plain PyTorch (logits_kernel.py:36-117): the CPU path and the card's
yardstick, never a card path of the port.

`attention_logits_pallas.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from agcn_tpu_torch.ops.kernels import build
from agcn_tpu_torch.ops.kernels.gcn_fused import _device_kind

P = 128   # packed (K*V) rows of the TPU formulation, padded
MAX_JOINTS = 32   # the kernel's tile: V padded to 32
# the kernel stages 64 contraction columns at a time; the split aims at
# eight blocks of 128 threads per SM and keeps at least 4 chunks a block
_CHUNK, _TARGET_BLOCKS, _MIN_CHUNKS = 64, 132 * 8, 4


def pack_rows(theta: torch.Tensor, num_subset: int,
              stride: int = 32) -> torch.Tensor:
    """(B, T, V, K, Ce) -> (B, 128, T*Ce): each subset's V rows start at
    k*stride."""
    b, t, v, k, ce = theta.shape
    th = theta.permute(0, 3, 2, 1, 4).reshape(b, k, v, t * ce)
    th = F.pad(th, (0, 0, 0, stride - v)).reshape(b, k * stride, t * ce)
    return F.pad(th, (0, 0, 0, P - k * stride))


def pack_cols(phi: torch.Tensor, num_subset: int,
              stride: int = 32) -> torch.Tensor:
    """(B, T, V, K, Ce) -> (B, T*Ce, 128) transposed packing."""
    b, t, v, k, ce = phi.shape
    ph = phi.permute(0, 1, 4, 3, 2).reshape(b, t * ce, k, v)
    ph = F.pad(ph, (0, stride - v)).reshape(b, t * ce, k * stride)
    return F.pad(ph, (0, P - k * stride))


def packed_logits_plain(th: torch.Tensor, ph_t: torch.Tensor) -> torch.Tensor:
    """S = th @ ph_t batched over B, in fp32: (B, 128, X) x (B, X, 128) ->
    (B, 128, 128) (the TPU kernel's product; its zero padding of X to a
    multiple of 128 adds nothing)."""
    b, p, x = th.shape
    if p != P or tuple(ph_t.shape) != (b, x, P):
        raise ValueError(f"expected (B, {P}, X) and (B, X, {P}), got "
                         f"{tuple(th.shape)} and {tuple(ph_t.shape)}")
    return torch.matmul(th.float(), ph_t.float())


def attention_logits_plain(theta: torch.Tensor, phi: torch.Tensor,
                           divisor: float) -> torch.Tensor:
    """The packed formulation: (B, T, V, K, Ce) theta/phi -> (B, K, V, V)
    fp32 logits."""
    b, t, v, k, ce = theta.shape
    s = packed_logits_plain(pack_rows(theta, k), pack_cols(phi, k))
    s = s.reshape(b, 4, 32, 4, 32)
    return torch.stack([s[:, i, :v, i, :v] for i in range(k)],
                       dim=1) / divisor


def splits_for(b: int, k: int, x: int) -> int:
    """Spans of the contraction: enough blocks for the card, fixed by the
    shapes alone (so the order of the sums is too)."""
    chunks = math.ceil(x / _CHUNK)
    most = max(1, chunks // _MIN_CHUNKS)
    return max(1, min(most, math.ceil(_TARGET_BLOCKS / (b * k))))


def _check(theta: torch.Tensor, phi: torch.Tensor) -> None:
    if theta.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"theta must be float32 or bfloat16, got "
                        f"{theta.dtype}")
    if phi.dtype != theta.dtype:
        raise TypeError(f"phi must have theta's dtype {theta.dtype}, got "
                        f"{phi.dtype}")
    if theta.dim() != 5 or tuple(phi.shape) != tuple(theta.shape):
        raise ValueError("expected theta and phi (B, T, V, K, Ce) of one "
                         f"shape; got {tuple(theta.shape)}, "
                         f"{tuple(phi.shape)}")
    if theta.shape[2] > MAX_JOINTS:
        raise ValueError(f"V={theta.shape[2]} joints: the kernel takes at "
                         f"most {MAX_JOINTS}")


def launch_logits(theta: torch.Tensor, phi: torch.Tensor,
                  divisor: float) -> torch.Tensor:
    """Launch `csrc/logits.cu` on the current stream (CUDA tensors, any
    strides)."""
    _check(theta, phi)
    b, t, v, k, ce = theta.shape
    out = torch.empty((b, k, v, v), dtype=torch.float32,
                      device=theta.device)
    if out.numel() == 0:
        return out
    if t * ce == 0:
        return out.zero_()
    splits = splits_for(b, k, t * ce)
    span = math.ceil(math.ceil(t * ce / splits) / _CHUNK) * _CHUNK
    splits = math.ceil(t * ce / span)
    partial = (torch.empty((splits, b, k, v, v), dtype=torch.float32,
                           device=theta.device) if splits > 1 else None)
    fn = getattr(build.load("logits"), "agcn_logits")
    if fn.argtypes is None:
        # without argtypes ctypes passes each int as a 32-bit C int and
        # cuts the pointers
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 10
                       + [ctypes.c_int] * 8 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device)
        err = fn(theta.data_ptr(), phi.data_ptr(), out.data_ptr(),
                 0 if partial is None else partial.data_ptr(),
                 *theta.stride(), *phi.stride(), b, t, v, k, ce, splits,
                 span, int(theta.dtype == torch.bfloat16), float(divisor),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"logits kernel launch failed: CUDA error {err}")
    return out


def attention_logits_pallas(theta: torch.Tensor, phi: torch.Tensor,
                            divisor: float) -> torch.Tensor:
    """The transposed-logits computation on the kernel:
    (B, T, V, K, Ce) theta/phi -> (B, K, V, V) fp32 logits, divided by
    `divisor`. CPU tensors take the plain version."""
    if _device_kind("attention_logits_pallas", theta, phi) == "cpu":
        return attention_logits_plain(theta, phi, divisor)
    out = launch_logits(theta, phi, divisor)
    attention_logits_pallas.launches += 1
    return out


attention_logits_pallas.launches = 0
