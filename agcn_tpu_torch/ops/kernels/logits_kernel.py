"""Embedding-attention logits on a hand-written Hopper kernel
(port of agcn_tpu/ops/pallas/logits_kernel.py).

  S[b,k,v,w] = sum_{t,c} theta[b,t,v,k,c] * phi[b,t,w,k,c] / divisor

`attention_logits_pallas(theta, phi, divisor)` is the entry point, with
the JAX signature: theta and phi (B, T, V, K, Ce) in fp32 or bf16, the
logits (B, K, V, V) in fp32, the sums in fp32. On CUDA tensors it
launches `csrc/logits.cu`, which computes only the K diagonal V x V
blocks that the TPU kernel cuts out of its 128 x 128 packed product, and
reads theta and phi through their strides: the theta/phi views of the
fused (B, T, V, 2*K*Ce) embedding need no copy. It stages chunks of
whole frames by `cp.async` (16-byte copies where the rows allow:
`copy_bytes`) and multiplies them on the tensor cores in bf16 and in
exact fp32 FMAs on the CUDA cores in fp32. `launch_plan` fixes, from the
shapes alone, the chunks and the spans the contraction is cut into
(enough blocks for the card at a served batch); a second kernel sums
the spans in span order, so two calls give bitwise-equal results. Like
the TPU kernel it has no backward. A call's host work is kept short,
since at a served batch it is near the kernel's device time: the C
entry's integers are cached by shape, strides and alignment
(`launch_args`), the spans' buffer is kept for each device and stream.

`pack_rows`, `pack_cols`, `packed_logits_plain` and
`attention_logits_plain` are the JAX package's packed formulation in
plain PyTorch (logits_kernel.py:36-117): the CPU path and the card's
yardstick, never a card path of the port.

`attention_logits_pallas.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from agcn_tpu_torch.ops.kernels import build
from agcn_tpu_torch.ops.kernels.gcn_fused import _device_kind

P = 128   # packed (K*V) rows of the TPU formulation, padded
MAX_JOINTS = 32   # the kernel's tile: V padded to 32
# The kernel stages chunks of whole frames, about _CHUNK_COLS[dtype]
# contraction columns each (a frame wider than _MAX_COLS channels is cut
# into parts of _MAX_COLS); a span keeps at least _MIN_CHUNKS chunks.
# _SLOTS: the block slots the span rule counts on, an H100's 132 SMs x
# the blocks an SM holds (logits.cu's note: three of logits_mma_kernel,
# two of logits_fp32_kernel). A constant, so that the spans, and the
# order of the sums, follow from the shapes alone on any card.
_CHUNK_COLS = {torch.bfloat16: 128, torch.float32: 160}
_MAX_COLS = 256
_MIN_CHUNKS = 4
_SLOTS = {torch.bfloat16: 132 * 3, torch.float32: 132 * 2}
# a block's set-up and first trip to memory, in chunks' time (fitted to
# the spans swept on the H100 at the served and training shapes)
_RAMP = 2


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


def splits_for(b: int, k: int, chunks: int, dtype: torch.dtype) -> int:
    """Spans of each (b, k) contraction of `chunks` chunks, from the
    shapes alone (so the order of the sums is too): the count that takes
    the least time through the card's block slots, counted as waves
    (ceil(b k s / slots)) times a block's time (ceil(chunks / s) chunks
    and its ramp), the fewest spans among equals."""
    most = max(1, chunks // _MIN_CHUNKS)
    return min(range(1, most + 1), key=lambda s: (
        math.ceil(b * k * s / _SLOTS[dtype])
        * (math.ceil(chunks / s) + _RAMP), s))


def launch_plan(b: int, t: int, k: int, ce: int,
                dtype: torch.dtype) -> dict:
    """What `csrc/logits.cu` walks, from the shapes alone: a chunk is
    `frames` whole frames x `cols` channels of each (`parts` chunks a
    frame group when Ce > _MAX_COLS), `width` staged columns (frames *
    cols rounded up to the MMA's 16); the (b, k) contraction's `chunks`
    go in `spans` spans of `span_chunks` chunks, summed in span order."""
    cols = min(ce, _MAX_COLS)
    frames = max(1, _CHUNK_COLS[dtype] // cols)
    parts = math.ceil(ce / cols)
    chunks = math.ceil(t / frames) * parts
    spans = splits_for(b, k, chunks, dtype)
    span_chunks = math.ceil(chunks / spans)
    return dict(frames=frames, cols=cols, parts=parts,
                width=math.ceil(frames * cols / 16) * 16, chunks=chunks,
                spans=math.ceil(chunks / span_chunks),
                span_chunks=span_chunks)


def launch_strides(shape: tuple, strides: tuple) -> tuple:
    """The strides with those of dims of length 1 set to 0: the kernel
    never steps along them, and their alignment is no concern."""
    return tuple(st if n > 1 else 0 for st, n in zip(strides, shape))


def copy_bytes(size: int, ce: int, cols: int, th_strides: tuple,
               ph_strides: tuple, offset: int) -> int:
    """The widest copy (16 or 4 bytes) that leaves every piece of a row
    inside that row and aligned, for elements of `size` bytes: unit
    channel strides, and the pointers (`offset`: their bitwise or, mod 16)
    and the launch strides on a multiple of it. Else one element a copy
    (fp32 by 4-byte cp.async, bf16 through registers)."""
    if th_strides[-1] != 1 or ph_strides[-1] != 1:
        return size
    # row starts and lengths, in elements
    spans = (ce, cols, *th_strides[:-1], *ph_strides[:-1])
    for width in (16, 4):
        if width > size and offset % width == 0 \
                and all((n * size) % width == 0 for n in spans):
            return width
    return size


# the integers the C entry takes in one array (`agcn_logits`' `args`)
LAUNCH_ARGS = 21


@functools.lru_cache(maxsize=256)
def launch_args(dtype: torch.dtype, shape: tuple, th_strides: tuple,
                ph_strides: tuple, offset: int) -> ctypes.Array:
    """The C entry's integers, from what fixes them: the dtype, the
    (B, T, V, K, Ce) shape, the two tensors' strides and their pointers'
    `offset` (bitwise or, mod 16). In `agcn_logits`' order: theta's and
    phi's launch strides, B, T, V, K, Ce, the plan's frames and cols, the
    copy bytes, the spans, the chunks a span, and 1 for bf16. Cached, and
    handed over as one array, so that a call repeats none of this work
    and converts no integer."""
    b, t, v, k, ce = shape
    plan = launch_plan(b, t, k, ce, dtype)
    sth, sph = launch_strides(shape, th_strides), launch_strides(shape,
                                                                 ph_strides)
    copy = copy_bytes(dtype.itemsize, ce, plan["cols"], sth, sph, offset)
    return (ctypes.c_longlong * LAUNCH_ARGS)(
        *sth, *sph, b, t, v, k, ce, plan["frames"], plan["cols"], copy,
        plan["spans"], plan["span_chunks"], int(dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _entry():
    """`agcn_logits` of the built library, its argument types set: without
    them ctypes passes each int as a 32-bit C int and cuts the
    pointers."""
    fn = build.load("logits").agcn_logits
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the spans' fp32 sums: for each device, one buffer and the stream it
# serves, grown as needed. Kernels on one stream run in order, so a
# call's reduce has read the buffer before the next call's kernel writes
# it; a call on another stream takes a new one.
_PARTIALS: dict = {}


def _partials(dev: int, stream: int, n: int) -> torch.Tensor:
    held = _PARTIALS.get(dev)
    if held is None or held[0] != stream or held[1].numel() < n:
        held = _PARTIALS[dev] = (stream, torch.empty(
            n, dtype=torch.float32, device=torch.device("cuda", dev)))
    return held[1]


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
    """Launch `csrc/logits.cu` on the current stream of theta's device
    (CUDA tensors, any strides)."""
    _check(theta, phi)
    dev = theta.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_logits(theta, phi, divisor)
    b, t, v, k, ce = theta.shape
    out = torch.empty((b, k, v, v), dtype=torch.float32,
                      device=theta.device)
    if out.numel() == 0:
        return out
    if t * ce == 0:
        return out.zero_()
    th_ptr, ph_ptr = theta.data_ptr(), phi.data_ptr()
    args = launch_args(theta.dtype, theta.shape, theta.stride(),
                       phi.stride(), (th_ptr | ph_ptr) % 16)
    # the raw handle of the current stream, without the Stream object
    # that torch.cuda.current_stream() builds at every call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    splits = args[-3]  # the span count
    partial = (_partials(dev, stream, out.numel() * splits).data_ptr()
               if splits > 1 else 0)
    err = _entry()(th_ptr, ph_ptr, out.data_ptr(), partial, args,
                   float(divisor), stream)
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
