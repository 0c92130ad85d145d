"""Fused adaptive graph convolution on hand-written Hopper kernels,
forward and backward (port of agcn_tpu/ops/pallas/gcn_fused.py).

  y[b,t,w,o] = sum_{k,v,c} x[b,t,v,c] * a1[b,k,v,w] * W[k,c,o]

Forward: `csrc/gcn_fwd.cu` computes it per (sample, frame tile, output
channel tile) block with the per-subset aggregate kept in shared memory,
never in device memory. One kernel serves both TPU forward kernels of the
JAX package; a flag picks the one real numerical difference between them
in bf16: `round_agg=True` rounds each per-subset aggregate to x's type
before the projection (gcn_fused.py:58-60), `round_agg=False` keeps it in
fp32 (gcn_kernel.py:45-49). The projection accumulates in fp32 over c and
k; y comes out in x's type. Inside the C entry `agcn_gcn_fwd`, bf16 x and
a1 go to `gcn_fwd_mma_kernel`, which runs both products on the tensor
cores (`nvcuda::wmma` bf16, fp32 sums): with `round_agg=True` (the served
forward and the dx of training) the aggregate is rounded to bf16 in
shared memory between them; with `round_agg=False` (gcn_kernel's
`fused_gcn`) each fp32 aggregate is split into two bf16 parts, hi =
bf16(a) and lo = bf16(a - hi), and both are projected on W. fp32 calls
and bf16 x with fp32 a1 go to `gcn_fwd_fp32_kernel` on the CUDA cores
(exact fp32 FMAs): each block forms the aggregate of its frames once for
all its 64 or 128 output channels (8 when Co <= 8), then projects it as
a register-tiled GEMM. There is no fallback between the two: a failed
launch raises.

Backward of `adaptive_gcn_pallas` (the JAX `_vjp_bwd`, gcn_fused.py:222):
  dx      = the forward kernel on (g, a1^T, W^T) with round_agg=True;
  dW, da1 = `csrc/gcn_bwd.cu` (`gcn_backward`): dW_k = sum x * u_k with
            u_k = g a1_k^T rounded to g's type, da1_k = sum p_k g with
            p_k = x W_k rounded to x's type; fp32 sums cast to W's and
            a1's types. u is formed once into device memory, then x^T u
            runs on the tensor cores (nvcuda::wmma) in bf16 and as a
            register-tiled GEMM on the CUDA cores in fp32; da1 is p =
            x W_k, rounded, then p g^T per frame, over groups of frames:
            on the tensor cores in bf16, in register tiles on the CUDA
            cores in fp32 (`gcn_da1_fp32_kernel`). Each block
            reduces over its rows itself and the dW and da1 partials of
            its groups are summed in a fixed order, so the result is
            deterministic (the TPU kernel's ordered-grid `+=` has no GPU
            counterpart).
`adaptive_gcn_pallas_hybrid` runs the same kernel forward with the
einsum cotangents of `ops.gcn.adaptive_gcn_bwd` (the JAX `_hyb_bwd`).

Which kernels run at which V. The kernels above are templates built for
the tuned joint counts `TUNED_JOINTS` (15, 18, 25: the skeletons of
graph/skeletons.py). Every other V >= 1, which the JAX Pallas kernels
take as well (AGCN and AAGCN on any `adj`, the 31-node STGAT expanded
graph among them), goes to the general kernels of the same sources,
with V a run-time argument and fixed 32-joint tiles, all math in exact
fp32 FMAs on the CUDA cores in both types: `gcn_fwd_gen_kernel` (the
forward of both round_agg modes and every type combination, so also dx
and `fused_gcn`), `gcn_u_gen_kernel` (u, then the same dW GEMMs, which
take V only through the B*T*V rows) and `gcn_da1_gen_kernel` (da1 by
32 x 32 (v, w) tiles over 4-frame tiles, then the same reduce). Their
only limits are the grid's (`_check` says them).

The TPU layout artefacts are not carried over: no zero-padding of the
contractions to 128, no time tiles in multiples of 8 with T padded up,
no routing of C < 8 elsewhere — the kernels mask their ragged edges and
run the C=3 entry layer too.

`gcn_fwd_plain` and `gcn_bwd_plain` are the same functions in plain
PyTorch, with the same rounding points. A wrapper takes them only for
CPU tensors; for CUDA tensors it launches the kernel or raises.

Launch counts: `adaptive_gcn_pallas.launches` counts the gcn_fwd
launches with round_agg (forwards of both pallas forms and the dx of
`pallas`), `gcn_backward.launches` the gcn_bwd calls (five kernels
each: u, the dW GEMM and its reduce, da1 and its reduce).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from agcn_tpu_torch.ops import gcn as gcn_ops
from agcn_tpu_torch.ops.kernels import build

K = 3  # subset count is structural in this architecture (reference A/B/C)
# the joint counts with tuned kernel templates: the skeletons of
# graph/skeletons.py (OpenPose 15, Kinetics, NTU); any other V >= 1 runs
# the general kernels
TUNED_JOINTS = (15, 18, 25)
# the general kernels' tiles of joints (gcn_fwd.cu G_WT, gcn_bwd.cu
# UG_VT and DG_VT) and the grid's limit on a y or z dimension
_GEN_JOINT_TILE, _GRID_YZ = 32, 65535
# gcn_bwd's bf16 dW tensor-core kernel: blocks of (64 x 64 channels, one
# subset, one group of 32-row chunks), about this many (8 per SM)
_MMA_TILE, _MMA_ROWS, _MMA_TARGET_BLOCKS = 64, 32, 1056
# its fp32 CUDA-core GEMM: blocks of (64 output x 64 input channels, or 8
# input channels for C <= 8, one subset, one group of 32-row chunks),
# about this many (8 per SM: two waves of four)
_DW32_TILE_O, _DW32_TILE_C, _DW32_NARROW_C = 64, 64, 8
_DW32_ROWS, _DW32_TARGET_BLOCKS = 32, 1056
# gcn_bwd's da1 kernels: blocks of (one group of frame tiles, one subset,
# one sample), at least this many (8 waves of two blocks an SM); the
# library says a tile's frames (`da1_tiling`), 4 in bf16
_DA1_TILE, _DA1_TARGET_BLOCKS = 4, 2112


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


def gcn_dw_plain(x: torch.Tensor, a1: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """dW of `gcn_bwd_plain` as fp32 sums: dW_k = x^T u_k with u_k = g
    a1_k^T rounded to g's type."""
    xf, gf = x.float(), g.float()
    dw = []
    for k in range(a1.shape[1]):
        u = torch.einsum("btwo,bvw->btvo", gf, a1[:, k].float())
        dw.append(torch.einsum("btvc,btvo->co", xf, u.to(g.dtype).float()))
    return torch.stack(dw)


def gcn_da1_plain(x: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """da1 of `gcn_bwd_plain` as fp32 sums: da1_k = sum_{t,o} p_k g with
    p_k = x W_k rounded to x's type."""
    xf, gf = x.float(), g.float()
    da1 = []
    for k in range(w.shape[0]):
        p = (xf @ w[k].float()).to(x.dtype).float()
        da1.append(torch.einsum("btvo,btwo->bvw", p, gf))
    return torch.stack(da1, dim=1)


def gcn_bwd_plain(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor):
    """Plain PyTorch version of gcn_bwd: (dW, da1) with u rounded to g's
    type and p to x's type, fp32 sums, dW in w's type and da1 in a1's
    (agcn_tpu gcn_fused.py:72-118, 200)."""
    return (gcn_dw_plain(x, a1, g).to(w.dtype),
            gcn_da1_plain(x, w, g).to(a1.dtype))


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
    vt = math.ceil(v / _GEN_JOINT_TILE)
    tiles = vt * math.ceil(max(c, w.shape[-1]) / _GEN_JOINT_TILE)
    if v < 1 or b > _GRID_YZ or (v not in TUNED_JOINTS and (
            K * vt * vt > _GRID_YZ or tiles > _GRID_YZ)):
        raise ValueError(
            f"B={b}, V={v}, C={c}, Co={w.shape[-1]}: the kernels take any "
            f"V >= 1 (tuned at {TUNED_JOINTS}) within their grids' limits: "
            f"B <= {_GRID_YZ} and, at an untuned V, 3 ceil(V/32)^2 <= "
            f"{_GRID_YZ} and ceil(V/32) ceil(max(C, Co)/32) <= {_GRID_YZ}")
    if not (x.is_contiguous() and a1.is_contiguous() and w.is_contiguous()):
        raise ValueError("x, a1 and w must be contiguous")


def _check_cotangent(x: torch.Tensor, w: torch.Tensor,
                     g: torch.Tensor) -> None:
    want = tuple(x.shape[:3]) + (w.shape[-1],)
    if g.dtype != x.dtype or tuple(g.shape) != want:
        raise ValueError(f"g must be {x.dtype} {want}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")


def _bind(name: str, symbol: str, n_ptr: int, n_int: int):
    fn = getattr(build.load(name), symbol)
    if fn.argtypes is None:
        # without argtypes ctypes passes each int as a 32-bit C int and
        # cuts the pointers
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_gcn_fwd(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                   round_agg: bool) -> torch.Tensor:
    """Launch `csrc/gcn_fwd.cu` on the current stream (CUDA tensors)."""
    _check(x, a1, w)
    b, t, v, c = x.shape
    co = w.shape[-1]
    y = torch.empty((b, t, v, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _bind("gcn_fwd", "agcn_gcn_fwd", 4, 8)
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


def dw_mma_groups(rows: int, c: int, co: int) -> int:
    """Row groups of gcn_bwd's bf16 dW kernel: ranges of whole 32-row
    chunks of the B*T*V rows, one fp32 (K, C, Co) partial each, fixed by
    the shapes alone."""
    tiles = math.ceil(co / _MMA_TILE) * math.ceil(c / _MMA_TILE) * K
    return max(1, min(math.ceil(rows / _MMA_ROWS),
                      math.ceil(_MMA_TARGET_BLOCKS / tiles)))


def dw_fp32_groups(rows: int, c: int, co: int) -> int:
    """Row groups of gcn_bwd's fp32 dW GEMM (`gcn_dw_fp32_kernel`):
    ranges of whole 32-row chunks of the B*T*V rows, one fp32 (K, C, Co)
    partial each, fixed by the shapes alone. C <= 8 takes the 8-channel
    C tile."""
    tile_c = _DW32_NARROW_C if c <= _DW32_NARROW_C else _DW32_TILE_C
    tiles = math.ceil(co / _DW32_TILE_O) * math.ceil(c / tile_c) * K
    return max(1, min(math.ceil(rows / _DW32_ROWS),
                      math.ceil(_DW32_TARGET_BLOCKS / tiles)))


def da1_groups(b: int, t: int, tile: int = _DA1_TILE) -> int:
    """Frame groups of gcn_bwd's da1 kernels: ranges of whole tiles of
    `tile` frames of a sample (the library's, `da1_tiling`: 4 in bf16, 5,
    7 or 8 in fp32 at V = 25, 18 or 15, 4 in both types at any other V),
    one fp32 (V, V) partial per (sample, subset, group), fixed by the
    shapes alone."""
    tiles = math.ceil(t / tile)
    return max(1, min(tiles, math.ceil(_DA1_TARGET_BLOCKS / (K * b))))


@functools.lru_cache(maxsize=None)
def da1_tiling(v: int, c: int, bf16: bool) -> tuple[int, int, int]:
    """What gcn_bwd's da1 launch takes at V joints and C input channels,
    from the library (`agcn_gcn_bwd_da1_tiling`, on the current CUDA
    device): (frames of a tile, dynamic shared memory of a block in
    bytes, blocks an SM holds)."""
    fn = getattr(build.load("gcn_bwd"), "agcn_gcn_bwd_da1_tiling")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    _raise_on(fn(v, c, int(bf16), out), "gcn_bwd da1 tiling")
    return out[0], out[1], out[2]


def _check_bwd(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
               g: torch.Tensor) -> None:
    _check(x, a1, w)
    _check_cotangent(x, w, g)
    if a1.dtype != x.dtype:
        raise TypeError(f"gcn_bwd takes a1 in x's dtype {x.dtype}, got "
                        f"{a1.dtype}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch_gcn_bwd_dw(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """dW of `csrc/gcn_bwd.cu` on the current stream (CUDA tensors), in
    w's dtype: u = g a1^T formed once into a (K, B*T*V, Co) buffer of x's
    dtype, then x^T u on the tensor cores (bf16) or as a register-tiled
    GEMM on the CUDA cores (fp32), one fp32 partial per row group summed
    in group order."""
    _check_bwd(x, a1, w, g)
    b, t, v, c = x.shape
    co = w.shape[-1]
    dw = torch.empty_like(w)
    if x.numel() == 0 or g.numel() == 0:
        return dw.zero_()
    bf16 = x.dtype == torch.bfloat16
    groups = (dw_mma_groups if bf16 else dw_fp32_groups)(b * t * v, c, co)
    u = torch.empty((K, b * t * v, co), dtype=x.dtype, device=x.device)
    partial = torch.empty((groups, K, c, co), dtype=torch.float32,
                          device=x.device)
    fn = _bind("gcn_bwd", "agcn_gcn_bwd_dw", 6, 7)
    # the C entry launches on the current device: make it x's for the
    # call, and leave the caller's current device as it was
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), a1.data_ptr(), g.data_ptr(), dw.data_ptr(),
                 partial.data_ptr(), u.data_ptr(),
                 b, t, v, c, co, groups, int(bf16), stream.cuda_stream)
    _raise_on(err, "gcn_bwd dW")
    return dw


def launch_gcn_bwd_da1(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """da1 of `csrc/gcn_bwd.cu` on the current stream (CUDA tensors), in
    a1's dtype: p = x W_k, then p g^T per frame, on the tensor cores in
    bf16 and in exact fp32 FMAs on the CUDA cores in fp32; one fp32
    (V, V) partial per (sample, subset, frame group) into a
    (B, K, G, V, V) buffer, summed in group order."""
    _check_bwd(x, a1, w, g)
    b, t, v, c = x.shape
    co = w.shape[-1]
    da1 = torch.empty_like(a1)
    if x.numel() == 0 or g.numel() == 0:
        return da1.zero_()
    bf16 = x.dtype == torch.bfloat16
    fn = _bind("gcn_bwd", "agcn_gcn_bwd_da1", 5, 7)
    with torch.cuda.device(x.device):
        groups = da1_groups(b, t, da1_tiling(v, c, bf16)[0])
        partial = torch.empty((b, K, groups, v, v), dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), da1.data_ptr(),
                 partial.data_ptr(), b, t, v, c, co, groups, int(bf16),
                 stream.cuda_stream)
    _raise_on(err, "gcn_bwd da1")
    return da1


def launch_gcn_bwd(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                   g: torch.Tensor):
    """Launch `csrc/gcn_bwd.cu` on the current stream (CUDA tensors):
    returns (dW, da1) in x's dtype, which a1 must share (the models build
    a1 in their compute dtype)."""
    return (launch_gcn_bwd_dw(x, a1, w, g), launch_gcn_bwd_da1(x, a1, w, g))


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    return kind


def gcn_forward(name: str, x: torch.Tensor, a1: torch.Tensor,
                w: torch.Tensor, round_agg: bool):
    """Dispatch on where the tensors lie: CPU -> plain version, CUDA ->
    the kernel. Returns (y, launched). Not differentiable: autograd goes
    through the Functions below."""
    if _device_kind(name, x, a1, w) == "cpu":
        return gcn_fwd_plain(x, a1, w, round_agg), False
    # the kernel reads dense rows: a strided view (AGCN's first-layer
    # input of a one-sample batch, whose person fold stays a view) is
    # copied first; a dense tensor passes as it is
    return launch_gcn_fwd(x.contiguous(), a1.contiguous(), w.contiguous(),
                          round_agg), True


def gcn_backward(x: torch.Tensor, a1: torch.Tensor, w: torch.Tensor,
                 g: torch.Tensor):
    """(dW, da1) of the fused GCN for the cotangent g: CPU -> the plain
    version, CUDA -> the gcn_bwd kernel."""
    if _device_kind("gcn_backward", x, a1, w, g) == "cpu":
        return gcn_bwd_plain(x, a1, w, g)
    out = launch_gcn_bwd(x.contiguous(), a1.contiguous(), w.contiguous(),
                         g.contiguous())
    gcn_backward.launches += 1
    return out


gcn_backward.launches = 0


def _forward_rounded(x: torch.Tensor, a1: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    y, launched = gcn_forward("adaptive_gcn_pallas", x, a1, w, True)
    if launched:
        adaptive_gcn_pallas.launches += 1
    return y


def needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _PallasGCN(torch.autograd.Function):
    """The JAX `_vjp_fwd` / `_vjp_bwd` pair (gcn_fused.py:218-230)."""

    @staticmethod
    def forward(ctx, x, a1, w):
        ctx.save_for_backward(x, a1, w)
        return _forward_rounded(x, a1, w)

    @staticmethod
    def backward(ctx, g):
        x, a1, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = da1 = dw = None
        if ctx.needs_input_grad[0]:
            # dx[b,t,v,c] = sum_{k,w,o} g a1 W: the same trilinear kernel
            # with the two small operands transposed
            dx = _forward_rounded(g, a1.transpose(2, 3).contiguous(),
                                  w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, da1 = gcn_backward(x, a1, w, g)
        return dx, da1, dw


class _PallasHybridGCN(torch.autograd.Function):
    """The JAX `_hyb_fwd` / `_hyb_bwd` pair (gcn_fused.py:248-256)."""

    @staticmethod
    def forward(ctx, x, a1, w):
        ctx.save_for_backward(x, a1, w)
        return _forward_rounded(x, a1, w)

    @staticmethod
    def backward(ctx, g):
        x, a1, w = ctx.saved_tensors
        dx, da1, dw = gcn_ops.adaptive_gcn_bwd(x, a1, w, g.to(x.dtype))
        return dx.to(x.dtype), da1.to(a1.dtype), dw.to(w.dtype)


def adaptive_gcn_pallas(x: torch.Tensor, a1: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Fused y = sum_k (x @_v a1_k) @_c W_k with the aggregate rounded to
    x's type (the gcn_fused semantics), trainable: its backward runs the
    forward kernel for dx and gcn_bwd for dW and da1.

    Args:
      x: (B, T, V, C) features (bf16 or f32).
      a1: (B, K, V, V) combined adjacency, a1[b,k,source,dest].
      w: (K, C, Co) per-subset projection kernels.
    Returns:
      (B, T, V, Co) in x.dtype.
    """
    if needs_grad(x, a1, w):
        return _PallasGCN.apply(x, a1, w)
    return _forward_rounded(x, a1, w)


adaptive_gcn_pallas.launches = 0


def adaptive_gcn_pallas_hybrid(x: torch.Tensor, a1: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """The same kernel forward with the einsum cotangents of
    `ops.gcn.adaptive_gcn_bwd` for the backward."""
    if needs_grad(x, a1, w):
        return _PallasHybridGCN.apply(x, a1, w)
    return _forward_rounded(x, a1, w)
