"""The premise of the card's bit-exact check of gcn_fwd, bf16 and fp32.

On the card, `tests/test_torch_port_cuda.py` and
`agcn_tpu_torch/tools/fwd_check.py` hold the tensor cores' kernel
(bf16, both round_agg modes) and the CUDA-core `gcn_fwd_fp32_kernel`
(fp32) equal to the port's plain version `gcn_fwd_plain` bit for bit on
small-integer inputs. Here, on the CPU, the same kind of inputs go
through the JAX package's Pallas kernels, as tests/test_pallas_gcn.py
runs them (interpret mode), and through `gcn_fwd_plain`:
`adaptive_gcn_pallas(..., interpret=True)` (the aggregate rounded to x's
type) must equal round_agg=True bit for bit, in bf16 and in fp32, and in
bf16 the same sums without that rounding must differ;
`gcn_kernel.fused_gcn(..., interpret=True)` (the aggregate kept in fp32)
must equal round_agg=False bit for bit, in both types. So the chain
reads: TPU kernel == plain version (here), CUDA kernel == plain version
(on the card).

With round_agg=False the card's kernel projects each fp32 aggregate as
two bf16 parts, hi = bf16(a) and lo = bf16(a - hi). Every integer
|n| < 2^17 is exactly hi + lo (checked here for all of them), so on
these inputs the split adds the same integers as the plain version; an
emulation of the split in PyTorch is held against it here too.

Inputs: x and a1 integers in [-8, 8], W in [-2, 2], exact in bf16. Each
aggregate is an integer of at most 25 * 64 = 1,600 and each fp32 sum of
the projection stays below 2^22, so every sum is exact in fp32 in any
order and only the two rounding points (the aggregate to bf16, y to
bf16) decide the result. Tolerance: none (bitwise).

Also the CPU-visible parts of the card check `fwd_check.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops.pallas.gcn_fused import adaptive_gcn_pallas
from agcn_tpu.ops.pallas.gcn_kernel import fused_gcn
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.tools import fwd_check
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# (B, T, C, Co, V): a narrow entry layer (C = 3), a dx-like Co = 3, a
# ragged last frame tile, Kinetics' 18 joints
SHAPES = [(2, 8, 16, 32, 25), (2, 6, 3, 64, 25), (2, 5, 64, 3, 25),
          (1, 7, 32, 16, 18)]


def _integer_inputs(b, t, c, co, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (b, t, v, c)).astype(np.float32),
            rng.integers(-8, 9, (b, 3, v, v)).astype(np.float32),
            rng.integers(-2, 3, (3, c, co)).astype(np.float32))


def _both(b, t, c, co, v, tpu_kernel=adaptive_gcn_pallas,
          dtype="bfloat16"):
    """The JAX Pallas kernel's result (interpret mode) as fp32, and the
    same inputs as tensors of `dtype` (bfloat16 or float32)."""
    arrs = _integer_inputs(b, t, c, co, v)
    arg = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    if tpu_kernel is fused_gcn:
        ref = fused_gcn(*arg, 64, True)
    else:
        ref = tpu_kernel(*arg, True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    x, a1, w = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return ref, x, a1, w


def _dtype_cases():
    """(dtype, B, T, C, Co, V) over both types at every shape; the bf16
    cases keep the ids they had before fp32 joined them."""
    return [pytest.param(d, *s, id="-".join(map(str, s)) if d == "bfloat16"
                         else "-".join(map(str, (d,) + s)))
            for d in ("bfloat16", "float32") for s in SHAPES]


def _split_projection(x, a1, w):
    """The card's round_agg=False arithmetic in PyTorch: each fp32
    aggregate a as hi = bf16(a) and lo = bf16(a - hi), both projected on
    the bf16 W with fp32 sums; y rounded to bf16."""
    acc = torch.zeros(x.shape[:3] + (w.shape[-1],))
    for k in range(a1.shape[1]):
        agg = torch.einsum("btvc,bvw->btwc", x.float(), a1[:, k].float())
        hi = agg.to(torch.bfloat16).float()
        lo = (agg - hi).to(torch.bfloat16).float()
        acc = acc + hi @ w[k].float() + lo @ w[k].float()
    return acc.to(x.dtype)


@pytest.mark.parametrize("dtype,b,t,c,co,v", _dtype_cases())
def test_plain_version_equals_the_tpu_kernel_bit_for_bit(dtype, b, t, c, co,
                                                         v):
    ref, x, a1, w = _both(b, t, c, co, v, dtype=dtype)
    got = tfused.gcn_fwd_plain(x, a1, w, True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, t, v, co)
    assert torch.equal(got.float(), ref)


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_the_aggregate_rounding_shows_on_these_inputs(b, t, c, co, v):
    """Without the rounding of the aggregate the result differs, so the
    bit-exact check sees where the kernel rounds."""
    ref, x, a1, w = _both(b, t, c, co, v)
    assert not torch.equal(tfused.gcn_fwd_plain(x, a1, w, False).float(),
                           ref)


@pytest.mark.parametrize("dtype,b,t,c,co,v", _dtype_cases())
def test_plain_version_equals_the_fp32_aggregate_tpu_kernel_bit_for_bit(
        dtype, b, t, c, co, v):
    """gcn_kernel's `_kernel` (the aggregate kept in fp32) is the plain
    version with round_agg=False."""
    ref, x, a1, w = _both(b, t, c, co, v, tpu_kernel=fused_gcn, dtype=dtype)
    got = tfused.gcn_fwd_plain(x, a1, w, False)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, t, v, co)
    assert torch.equal(got.float(), ref)


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_in_fp32_the_two_tpu_kernels_are_one_function(b, t, c, co, v):
    """In fp32 the aggregate's rounding is the identity: both TPU kernels
    and both round_agg modes of the plain version give one result, so one
    CUDA-core kernel serves both."""
    ref, x, a1, w = _both(b, t, c, co, v, dtype="float32")
    ref0, *_ = _both(b, t, c, co, v, tpu_kernel=fused_gcn, dtype="float32")
    assert torch.equal(ref, ref0)
    assert torch.equal(tfused.gcn_fwd_plain(x, a1, w, True),
                       tfused.gcn_fwd_plain(x, a1, w, False))


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_split_aggregate_equals_the_plain_version_bit_for_bit(
        b, t, c, co, v):
    """On integer inputs the hi + lo split of the card's round_agg=False
    path changes nothing, and it is not the round_agg=True result."""
    _, x, a1, w = _both(b, t, c, co, v)
    got = _split_projection(x, a1, w)
    assert torch.equal(got, tfused.gcn_fwd_plain(x, a1, w, False))
    assert not torch.equal(got, tfused.gcn_fwd_plain(x, a1, w, True))


def test_every_integer_below_2_17_is_its_two_bf16_parts():
    """The premise of the split's bit-exact check, for every integer
    |n| < 2^17 (the rounding-modes inputs' aggregates reach 102,400):
    n == bf16(n) + bf16(n - bf16(n)) exactly."""
    n = torch.arange(-(2 ** 17) + 1, 2 ** 17, dtype=torch.float32)
    hi = n.to(torch.bfloat16).float()
    lo = (n - hi).to(torch.bfloat16).float()
    assert torch.equal(hi + lo, n)
    assert not torch.equal(hi, n)  # one part alone would not do


def test_integer_inputs_keep_every_sum_exact():
    """At the widest shape the card checks (C = Co = 256) every aggregate
    is an integer of at most 1,600, every projection sum stays below
    2^22, and fp32 sums in another order equal the float64 ones."""
    x, a1, w = (torch.from_numpy(a).double()
                for a in _integer_inputs(1, 4, 256, 256, 25, seed=1))
    aggs = [torch.einsum("btvc,bvw->btwc", x, a1[:, k]) for k in range(3)]
    assert all(bool((g.abs() <= 1600).all()) for g in aggs)
    assert all(torch.equal(g, g.round()) for g in aggs)
    rounded = [g.to(torch.bfloat16).double() for g in aggs]
    y64 = sum(g @ w[k] for k, g in enumerate(rounded))
    y32 = sum(rounded[k].float() @ w[k].float() for k in (2, 1, 0))
    assert y64.abs().max() < 2 ** 22
    assert torch.equal(y32.double(), y64)


def test_fwd_check_yardstick_computes_the_function():
    """The card check's library yardstick computes the function (fp32,
    on the CPU, against the plain version)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 25, 16)).astype(
        np.float32))
    a1 = torch.from_numpy(rng.standard_normal((2, 3, 25, 25)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 24)).astype(
        np.float32))
    torch.testing.assert_close(fwd_check.library_fwd(torch, x, a1, w),
                               tfused.gcn_fwd_plain(x, a1, w, True),
                               atol=1e-4, rtol=1e-4)


def test_fwd_check_entry_sums_the_layers():
    """A `kernels` entry sums each row times its layer count, and the dx
    rows go under "dx" with their own bound."""
    row = dict(round_agg=True, dtype="bfloat16", layers=3, ms=1.0,
               plain_ms=2.0, library_ms=4.0, flops=1e9, bytes=1e6,
               max_abs_err=0.5)
    entry = fwd_check.fwd_entry([row], True, "bfloat16", 7, "gcn_fwd",
                                "agcn_tpu/ops/pallas/gcn_fused.py:52",
                                [dict(row, layers=2)])
    assert (entry["ms"], entry["plain_ms"], entry["library_ms"]) == (
        3.0, 6.0, 12.0)
    assert entry["launches"] == 7 and entry["bound_by"] == "operations"
    assert entry["dx"]["ms"] == 2.0
    assert entry["bound_ms"] == pytest.approx(3e9 / 989e12 * 1e3)


def test_fwd_check_refuses_without_gpu(capsys):
    """`python -m agcn_tpu_torch.tools.fwd_check` times the card: without
    one it exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert fwd_check.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA GPU" in out.err


def test_fwd_check_finds_spills_of_the_mma_kernel():
    """`spilling` reads `nvcc -Xptxas -v`: spill stores or loads of a
    gcn_fwd_mma_kernel or gcn_fwd_fp32_kernel instantiation are found,
    other kernels' ignored."""
    mma = "_ZN12_GLOBAL__N_118gcn_fwd_mma_kernelILi25ELi32ELb1EEEvPKii"
    fp32 = "_ZN12_GLOBAL__N_119gcn_fwd_fp32_kernelIfLi25ELi64ELi16EEEvPKT_"
    other = "_ZN12_GLOBAL__N_114gcn_fwd_kernelIffLi25ELi32EEEvPKii"
    entry = ("ptxas info    : Compiling entry function '{0}' for 'sm_90a'\n"
             "ptxas info    : Function properties for {0}\n"
             "    0 bytes stack frame, {1} bytes spill stores, {2} bytes "
             "spill loads\n"
             "ptxas info    : Used 128 registers, 101376 bytes smem\n")
    clean = (entry.format(mma, 0, 0) + entry.format(fp32, 0, 0)
             + entry.format(other, 8, 8))
    assert fwd_check.spilling(clean) == []
    assert fwd_check.spilling(clean + entry.format(mma, 4, 12)) == [
        (mma, 4, 12)]
    assert fwd_check.spilling(clean + entry.format(fp32, 16, 16)) == [
        (fp32, 16, 16)]
