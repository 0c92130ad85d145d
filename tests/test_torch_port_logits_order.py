"""The order of sums of the card's attention-logits kernel, emulated on the
CPU.

On the card, `attention_logits_pallas` launches `csrc/logits.cu`
(agcn_tpu_torch/ops/csrc/logits.cu), which sums in an order of its own,
fixed by `launch_plan` from the shapes alone: each (sample, subset)
contraction over x = (t, c) is cut into spans of whole chunks; a chunk is
`frames` whole frames x `cols` channels of each (a frame wider than 256
channels in parts), staged as s[v][x] in a ring of three buffers, zeros
past T and Ce and in the padding rows and columns. In bf16 the 8 warps
take the chunk's 16-wide steps of x round-robin, each adding a 32 x 32
product into its own fp32 tiles, and the warps are summed in warp order;
in fp32 each (v, w) is summed by the slices of the chunk's x quads
(nearly equal runs), each column in order, and the slices in slice order.
The spans' sums are added in span order (0 + s_0 + s_1 + ..., by a second
kernel) and divided once.
`_emulated` does the same in numpy, with the ring filled with NaN where
nothing writes it (a read of an unwritten element would show).

Held here against the JAX package's Pallas kernel
(`attention_logits_pallas(..., interpret=True)`, as
tests/test_torch_port_logits.py runs it) at that suite's bar (atol and
rtol 1e-5), and bit for bit against the port's plain version
`attention_logits_plain` on integer inputs in [-2, 2] (every sum an
integer below 2^24, exact in fp32 in any order). The card tests hold the
kernel itself against the plain version (tests/test_torch_port_cuda.py).
The emulation adds each product as a multiply and an add where the
kernel fuses them (fmaf) or sums 16 inside an MMA, which changes no
integer sum.

Also the launch plan, the copy width the wrapper picks, and the
CPU-visible parts of the card check (`tools/logits_check.py`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops.pallas import logits_kernel as jlk
from agcn_tpu_torch.ops.kernels import logits_kernel as tlk
from agcn_tpu_torch.tools import logits_check
from tests.torch_port_threads import one_torch_thread  # noqa: F401

STAGES, WARPS, THREADS = 3, 8, 256
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, T, V, K, Ce): T off the chunk at every shape; V = 25, 18 (their
# fp32 tiles) and 15, 7 (the general one); Ce = 16, 8 and 12 (4-byte
# copies in bf16), and 300 (two parts a frame)
SHAPES = [(2, 13, 25, 3, 16), (2, 21, 18, 3, 8), (1, 9, 15, 3, 12),
          (2, 11, 7, 2, 12), (1, 3, 7, 2, 300)]


def _fp32_tile(v):
    """F32Tile<V> of logits.cu: (register-tile side, tiles along v,
    slices a tile)."""
    vt, nt = {25: (5, 5), 18: (6, 3)}.get(v, (4, 8))
    return vt, nt, THREADS // (nt * nt)


def _emulated(theta, phi, divisor, plan=None):
    """The kernel's decomposition in numpy: (B, T, V, K, Ce) theta/phi ->
    (B, K, V, V) fp32 logits."""
    bf16 = theta.dtype == torch.bfloat16
    b, t, v, k, ce = theta.shape
    plan = plan or tlk.launch_plan(b, t, k, ce, theta.dtype)
    f, cols, parts = plan["frames"], plan["cols"], plan["parts"]
    width = plan["width"]
    assert plan["parts"] == math.ceil(ce / cols)
    assert plan["chunks"] == math.ceil(t / f) * parts
    th = theta.float().permute(0, 3, 1, 2, 4).numpy()  # (B, K, T, V, Ce)
    ph = phi.float().permute(0, 3, 1, 2, 4).numpy()
    if bf16:
        rows, ld = 32, width + 8
    else:
        vt, nt, slices = _fp32_tile(v)
        rows, ld = vt * nt, width + 4
    # the ring: NaN where no copy and no zeroing writes
    ring = np.full((STAGES, 2, b, k, rows, ld), np.nan, np.float32)
    ring[..., v:, :width] = 0
    ring[..., :v, f * cols:width] = 0

    def stage(ci, buf):
        grp, p = divmod(ci, parts)
        t0, c0 = grp * f, p * cols
        tv, cv = min(f, t - t0), min(cols, ce - c0)
        for i, src in enumerate((th, ph)):
            blk = np.zeros((b, k, f, v, cols), np.float32)
            blk[:, :, :tv, :, :cv] = src[:, :, t0:t0 + tv, :, c0:c0 + cv]
            ring[buf, i, :, :, :v, :f * cols] = blk.transpose(
                0, 1, 3, 2, 4).reshape(b, k, v, f * cols)

    partials = []
    for s in range(plan["spans"]):
        first = s * plan["span_chunks"]
        n = min(plan["chunks"], first + plan["span_chunks"]) - first
        assert n > 0
        acc = np.zeros((WARPS if bf16 else slices, b, k, rows, rows),
                       np.float32)
        for i in range(n):
            buf = i % STAGES
            stage(first + i, buf)
            a, p = ring[buf, 0, ..., :width], ring[buf, 1, ..., :width]
            if bf16:
                for ks in range(width // 16):
                    x = slice(16 * ks, 16 * ks + 16)
                    acc[ks % WARPS] += a[..., x] @ p[..., x].swapaxes(-1, -2)
            else:
                quads = width // 4
                for sl in range(slices):
                    for x in range(4 * (sl * quads // slices),
                                   4 * ((sl + 1) * quads // slices)):
                        acc[sl] += a[..., :, x, None] * p[..., None, :, x]
        total = np.zeros((b, k, rows, rows), np.float32)
        for part in acc:  # warp or slice order
            total += part
        partials.append(total[..., :v, :v])
    out = partials[0]
    if len(partials) > 1:
        out = np.zeros_like(out)
        for part in partials:  # span order, from 0
            out = out + part
    return torch.from_numpy(out / np.float32(divisor))


def _views(shape, dname, seed, integers=False):
    """theta, phi as the strided views of a fused (B, T, V, 2 K Ce)
    embedding, in `dname`: normal or integers in [-2, 2]."""
    b, t, v, k, ce = shape
    rng = np.random.default_rng(seed)
    size = (b, t, v, 2 * k * ce)
    emb = (rng.integers(-2, 3, size) if integers
           else rng.standard_normal(size)).astype(np.float32)
    e = torch.from_numpy(emb).to(DTYPES[dname]).view(b, t, v, 2, k, ce)
    return e[..., 0, :, :], e[..., 1, :, :]


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulation_is_the_plain_version_on_integers(shape, dname):
    th, ph = _views(shape, dname, 1, integers=True)
    div = shape[1] * shape[4]
    got = _emulated(th, ph, div)
    want = tlk.attention_logits_plain(th, ph, div)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,dname", [
    (SHAPES[0], "float32"), (SHAPES[1], "bfloat16"), (SHAPES[2], "float32")])
def test_emulation_matches_jax_interpret(shape, dname):
    th, ph = _views(shape, dname, 2)
    div = shape[1] * shape[4]
    jd = jnp.float32 if dname == "float32" else jnp.bfloat16
    want = jlk.attention_logits_pallas(jnp.asarray(th.float().numpy(), jd),
                                       jnp.asarray(ph.float().numpy(), jd),
                                       div, interpret=True)
    np.testing.assert_allclose(_emulated(th, ph, div).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_emulation_over_many_spans(dname):
    """T long enough for several spans at a small batch; and a plan
    forced to one chunk a span: the same sums, the same integers."""
    shape = (1, 200, 25, 3, 8)
    th, ph = _views(shape, dname, 3, integers=True)
    plan = tlk.launch_plan(1, 200, 3, 8, DTYPES[dname])
    assert plan["spans"] > 1
    want = tlk.attention_logits_plain(th, ph, 1600)
    assert torch.equal(_emulated(th, ph, 1600), want)
    one = dict(plan, span_chunks=1, spans=plan["chunks"])
    assert torch.equal(_emulated(th, ph, 1600, one), want)
    th, ph = _views(shape, dname, 4)
    np.testing.assert_allclose(_emulated(th, ph, 1600, one).numpy(),
                               tlk.attention_logits_plain(th, ph, 1600)
                               .numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,t,ce,dname,frames,width,spans,span_chunks", [
    # the served batch (16 streams x 2 persons) and the training batch
    (32, 300, 16, "bfloat16", 8, 128, 4, 10),
    (32, 300, 16, "float32", 10, 160, 5, 6),
    (32, 150, 64, "float32", 2, 128, 5, 15),
    (128, 300, 32, "bfloat16", 4, 128, 1, 75),
    (128, 75, 64, "float32", 2, 128, 2, 19),
    # a short contraction takes one span; a wide frame goes in parts
    (3, 20, 16, "bfloat16", 8, 128, 1, 3),
    (1, 3, 300, "float32", 1, 256, 1, 6)])
def test_launch_plan(b, t, ce, dname, frames, width, spans, span_chunks):
    plan = tlk.launch_plan(b, t, 3, ce, DTYPES[dname])
    assert (plan["frames"], plan["width"], plan["spans"],
            plan["span_chunks"]) == (frames, width, spans, span_chunks)
    # whole chunks of whole frames; every span holds one chunk at least
    assert plan["frames"] * plan["cols"] <= plan["width"] < (
        plan["frames"] * plan["cols"] + 16)
    assert plan["width"] % 16 == 0
    assert (plan["spans"] - 1) * plan["span_chunks"] < plan["chunks"] <= (
        plan["spans"] * plan["span_chunks"])


@pytest.mark.parametrize("b,k,chunks,dname,spans", [
    (32, 3, 38, "bfloat16", 4), (32, 3, 75, "float32", 5),
    (128, 3, 38, "bfloat16", 1), (128, 3, 60, "float32", 2),
    (1, 3, 13, "bfloat16", 3), (2, 3, 7, "float32", 1)])
def test_spans_fill_the_block_slots(b, k, chunks, dname, spans):
    """The span count: the least waves (ceil(b k s / slots)) times a
    block's chunks and ramp; never fewer than _MIN_CHUNKS chunks a span
    when split."""
    got = tlk.splits_for(b, k, chunks, DTYPES[dname])
    assert got == spans
    assert got == 1 or math.ceil(chunks / got) >= tlk._MIN_CHUNKS
    slots = tlk._SLOTS[DTYPES[dname]]
    cost = lambda s: (math.ceil(b * k * s / slots)  # noqa: E731
                      * (math.ceil(chunks / s) + tlk._RAMP))
    assert all(cost(got) <= cost(s)
               for s in range(1, max(1, chunks // tlk._MIN_CHUNKS) + 1))


def _copy(th, ph, cols):
    """The copy width the wrapper picks for theta/phi staged `cols`
    channels a frame."""
    return tlk.copy_bytes(th.element_size(), th.shape[-1], cols,
                          tlk.launch_strides(th.shape, th.stride()),
                          tlk.launch_strides(ph.shape, ph.stride()),
                          (th.data_ptr() | ph.data_ptr()) % 16)


def test_copy_bytes_follow_the_rows():
    th, ph = _views((2, 5, 25, 3, 16), "float32", 0)
    assert _copy(th, ph, 16) == 16
    assert _copy(th.bfloat16(), ph.bfloat16(), 16) == 16
    bt, bp = _views((2, 5, 25, 3, 12), "bfloat16", 0)
    assert _copy(bt, bp, 12) == 4     # 24-byte rows
    bt, bp = _views((2, 5, 25, 3, 3), "bfloat16", 0)
    assert _copy(bt, bp, 3) == 2      # 6-byte rows: registers
    # a channel stride other than 1, or a row off the 16-byte grid
    tt = th.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert tt.stride(-1) != 1 and _copy(tt, ph, 16) == 4
    off = torch.zeros(2 * 5 * 25 * 3 * 16 + 1)[1:].view(2, 5, 25, 3, 16)
    assert _copy(off, off, 16) == 4
    # dims of length 1 do not count
    one = torch.zeros(1, 1, 25, 3, 16).as_strided((1, 1, 25, 3, 16),
                                                  (7, 3, 48, 16, 1))
    assert tlk.launch_strides(one.shape, one.stride()) == (0, 0, 48, 16, 1)
    assert _copy(one, one, 16) == 16


@pytest.mark.parametrize("dname", list(DTYPES))
def test_launch_args_follow_the_plan(dname):
    """The C entry's integers, as the wrapper caches them: both tensors'
    launch strides, the shape, the plan, the copy width and the dtype, in
    the order `agcn_logits` reads them."""
    dtype = DTYPES[dname]
    e = torch.zeros(32, 300, 25, 2, 3, 16, dtype=dtype)
    th, ph = e[..., 0, :, :], e[..., 1, :, :]
    args = tlk.launch_args(dtype, th.shape, th.stride(), ph.stride(),
                           (th.data_ptr() | ph.data_ptr()) % 16)
    plan = tlk.launch_plan(32, 300, 3, 16, dtype)
    assert len(args) == tlk.LAUNCH_ARGS
    assert tuple(args) == (*th.stride(), *ph.stride(), 32, 300, 25, 3, 16,
                    plan["frames"], plan["cols"], _copy(th, ph, 16),
                    plan["spans"], plan["span_chunks"],
                    int(dtype == torch.bfloat16))
    assert args[-4] == 16 and args[-3] == plan["spans"] > 1


def test_logits_check_work_and_entry():
    """The bounds and the `kernels` entry of tools/logits_check.py: each
    layer bound by bytes; the entry sums the ten layers at batch 32."""
    flops, nbytes = logits_check.logits_work(32, 300, 16, "bfloat16")
    assert flops == 2 * 32 * 3 * 625 * 300 * 16
    assert nbytes == 2 * 32 * 300 * 25 * 48 * 2 + 32 * 3 * 625 * 4
    rows = []
    for b in (32, 128):
        for (t, ce), mult in logits_check.LOGITS_SHAPES:
            for dname in DTYPES:
                fl, nb = logits_check.logits_work(b, t, ce, dname)
                rows.append(dict(b=b, t=t, ce=ce, layers=mult, dtype=dname,
                                 ms=1.0, device_ms=0.5, plain_ms=2.0,
                                 library_ms=3.0, flops=fl, bytes=nb,
                                 max_abs_err=b * 1e-8))
    entry = logits_check.logits_entry(rows, 20, "float32")
    assert entry["ms"] == 10.0 and entry["device_ms"] == 5.0
    assert entry["launches"] == 20
    # the error: the worst row of both batches and both dtypes
    assert entry["max_abs_err"] == 128e-8
    assert entry["bound_by"] == "bytes"
    assert entry["bound_ms"] == pytest.approx(0.331, abs=5e-4)
    assert entry["replaces"] == "agcn_tpu/ops/pallas/logits_kernel.py:30"


def test_logits_check_finds_spills():
    log = "\n".join([
        "ptxas info    : Function properties for _Z17logits_mma_kernelPK",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers",
        "ptxas info    : Function properties for "
        "_Z18logits_fp32_kernelILi25EE",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers",
        "ptxas info    : Function properties for _Z14gcn_u_kernel",
        "    0 bytes stack frame, 16 bytes spill stores, "
        "16 bytes spill loads"])
    assert logits_check.logits_spills(log) == [
        ("_Z18logits_fp32_kernelILi25EE", 8, 4)]
    assert [r["registers"] for r in logits_check.report_build(log)] == [
        80, 128]
