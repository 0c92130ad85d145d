"""The premise of the card's bit-exact check of gcn_fwd's bf16 path.

On the card, `tests/test_torch_port_cuda.py` and
`agcn_tpu_torch/tools/fwd_check.py` hold the tensor cores' kernel
(bf16, round_agg=1) equal to the port's plain version `gcn_fwd_plain` bit
for bit on small-integer inputs. Here, on the CPU, the same kind of
inputs go through the JAX package's Pallas kernel
(`adaptive_gcn_pallas(..., interpret=True)`, as tests/test_pallas_gcn.py
runs it) and through `gcn_fwd_plain`: the two must be bit for bit equal,
and the same sums without the rounding of the aggregate must differ. So
the chain reads: TPU kernel == plain version (here), CUDA kernel == plain
version (on the card).

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


def _both(b, t, c, co, v):
    arrs = _integer_inputs(b, t, c, co, v)
    ref = adaptive_gcn_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                              True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    x, a1, w = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    return ref, x, a1, w


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_plain_version_equals_the_tpu_kernel_bit_for_bit(b, t, c, co, v):
    ref, x, a1, w = _both(b, t, c, co, v)
    got = tfused.gcn_fwd_plain(x, a1, w, True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, v, co)
    assert torch.equal(got.float(), ref)


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_the_aggregate_rounding_shows_on_these_inputs(b, t, c, co, v):
    """Without the rounding of the aggregate the result differs, so the
    bit-exact check sees where the kernel rounds."""
    ref, x, a1, w = _both(b, t, c, co, v)
    assert not torch.equal(tfused.gcn_fwd_plain(x, a1, w, False).float(),
                           ref)


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
