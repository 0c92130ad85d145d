"""Port backward passes against agcn_tpu on the CPU: the fused-GCN
autograd Functions and the gcn_bwd plain version against `jax.vjp` of
the JAX forms (Pallas kernels in interpret mode, as
tests/test_pallas_gcn.py runs them), with the same seeded numpy inputs.

Tolerances: fp32 1e-4 x the tensor's max |value| (sums of another
order); bf16 2^-6 x max |value| (each output is one bf16 rounding of an
fp32 sum, and the intermediates u and p are rounded once more). On
integer inputs whose every sum is exact in fp32, the plain version must
equal JAX's bit for bit, and dropping the rounding of u or of p must not.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu.ops.pallas import gcn_kernel as jkernel
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.ops.kernels import gcn_kernel as tkernel
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# tests/test_pallas_gcn.py's shapes (t, c, co), plus the C=3 entry layer
SHAPES = [(40, 32, 16), (50, 64, 64), (40, 3, 16)]
_BF16 = 2.0 ** -6


def _inputs(t, c, co, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, 25, c), (b, 3, 25, 25), (3, c, co),
                      (b, t, 25, co))]


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _close(got, want, rel, name=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def _jax_vjp(fn, x, a1, w, g, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (x, a1, w)]
    y, vjp = jax.vjp(fn, *args)
    return (y,) + vjp(jnp.asarray(g, dtype))


def _port_vjp(fn, x, a1, w, g, dtype=torch.float32):
    args = [_t(a, dtype, grad=True) for a in (x, a1, w)]
    y = fn(*args)
    y.backward(_t(g, dtype))
    return (y.detach(),) + tuple(a.grad for a in args)


_FORMS = {
    "pallas": (lambda x, a1, w: jfused.adaptive_gcn_pallas(x, a1, w, True),
               tfused.adaptive_gcn_pallas),
    "pallas_hybrid": (
        lambda x, a1, w: jfused.adaptive_gcn_pallas_hybrid(x, a1, w, True),
        tfused.adaptive_gcn_pallas_hybrid),
    "fused_gcn": (lambda x, a1, w: jkernel.fused_gcn(x, a1, w, 16, True),
                  tkernel.fused_gcn),
}


@pytest.mark.parametrize("t,c,co", SHAPES)
@pytest.mark.parametrize("form", list(_FORMS))
def test_autograd_functions_match_jax_vjp(form, t, c, co):
    """Value and the grads of x, a1 and W, fp32."""
    x, a1, w, g = _inputs(t, c, co)
    jfn, tfn = _FORMS[form]
    want = _jax_vjp(jfn, x, a1, w, g)
    got = _port_vjp(tfn, x, a1, w, g)
    for name, a, b in zip(("y", "dx", "da1", "dw"), got, want):
        _close(a.numpy(), b, 1e-4, name)
    # on CPU tensors the plain versions ran: no launch
    assert tfused.adaptive_gcn_pallas.launches == 0
    assert tfused.gcn_backward.launches == 0
    assert tkernel.fused_gcn.launches == 0


@pytest.mark.parametrize("form", list(_FORMS))
def test_autograd_functions_bf16_close_to_jax(form):
    x, a1, w, g = _inputs(40, 32, 16, seed=1)
    w = w / np.sqrt(3 * 32)
    jfn, tfn = _FORMS[form]
    want = _jax_vjp(jfn, x, a1, w, g, jnp.bfloat16)
    got = _port_vjp(tfn, x, a1, w, g, torch.bfloat16)
    for name, a, b in zip(("y", "dx", "da1", "dw"), got, want):
        assert a.dtype == torch.bfloat16, name
        _close(a.float().numpy(), np.asarray(b, np.float32), _BF16, name)


@pytest.mark.parametrize("t,c,co", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_bwd_plain_matches_jax_backward(t, c, co, dtype):
    x, a1, w, g = _inputs(t, c, co, seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfused._backward(*(jnp.asarray(a, jdt) for a in (x, a1, w, g)),
                            True)
    got = tfused.gcn_bwd_plain(*(_t(a, tdt) for a in (x, a1, w, g)))
    for a, b in zip(got, want):
        assert a.dtype == tdt
        _close(a.float().numpy(), np.asarray(b, np.float32),
               1e-4 if dtype == "float32" else _BF16)


def _integer_inputs(seed=3):
    """bf16 integers whose every sum is exact in fp32: u (|u| ~ 2^11) and
    p (|p| ~ 2^9) lose bits when rounded to bf16's 8, the dW and da1 sums
    stay far below 2^24."""
    rng = np.random.default_rng(seed)
    b, t, c, co = 2, 8, 64, 16
    x = rng.integers(-4, 5, (b, t, 25, c))
    a1 = rng.integers(-32, 33, (b, 3, 25, 25))
    w = rng.integers(-32, 33, (3, c, co))
    g = rng.integers(-32, 33, (b, t, 25, co))
    return x, a1, w, g


def _bwd_without_rounding(x, a1, w, g, round_u, round_p):
    xf, gf = x.float(), g.float()
    dw, da1 = [], []
    for k in range(3):
        u = torch.einsum("btwo,bvw->btvo", gf, a1[:, k].float())
        if round_u:
            u = u.to(g.dtype).float()
        dw.append(torch.einsum("btvc,btvo->co", xf, u))
        p = xf @ w[k].float()
        if round_p:
            p = p.to(x.dtype).float()
        da1.append(torch.einsum("btvo,btwo->bvw", p, gf))
    return (torch.stack(dw).to(w.dtype),
            torch.stack(da1, dim=1).to(a1.dtype))


def test_gcn_bwd_rounding_points_in_bf16():
    ints = _integer_inputs()
    want = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            jfused._backward(*(jnp.asarray(a, jnp.bfloat16) for a in ints),
                             True)]
    args = [_t(a, torch.bfloat16) for a in ints]
    dw, da1 = tfused.gcn_bwd_plain(*args)
    assert torch.equal(dw.float(), want[0])
    assert torch.equal(da1.float(), want[1])
    # the helper reproduces the plain version with both roundings
    both = _bwd_without_rounding(*args, True, True)
    assert torch.equal(both[0], dw) and torch.equal(both[1], da1)
    no_u = _bwd_without_rounding(*args, False, True)
    no_p = _bwd_without_rounding(*args, True, False)
    assert (no_u[0].float() != want[0]).float().mean() > 0.2
    assert (no_p[1].float() != want[1]).float().mean() > 0.2


def test_einsum_backward_matches_jax():
    """ops.gcn.adaptive_gcn_bwd against the JAX `_adaptive_gcn_bwd`."""
    x, a1, w, g = _inputs(24, 16, 32, seed=4)
    want = jgcn._adaptive_gcn_bwd(
        tuple(jnp.asarray(a) for a in (x, a1, w)), jnp.asarray(g))
    got = tgcn.adaptive_gcn_bwd(*(_t(a) for a in (x, a1, w, g)))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-4)


def test_dw_fp32_groups_fill_the_card_within_the_row_chunks():
    """The fp32 dW GEMM's groups of 32-row chunks: 1,056 blocks (8 per
    SM on 132 SMs) at each training layer shape (C = 3 on the 8-channel
    C tile), never more groups than chunks."""
    rows = {300: 128 * 300 * 25, 150: 128 * 150 * 25, 75: 128 * 75 * 25}
    for (t, c, co), groups in [((300, 3, 64), 352), ((300, 64, 64), 352),
                               ((300, 64, 128), 176), ((150, 128, 128), 88),
                               ((150, 128, 256), 44), ((75, 256, 256), 22)]:
        assert tfused.dw_fp32_groups(rows[t], c, co) == groups
        tile_c = 8 if c <= 8 else 64
        assert groups * 3 * math.ceil(c / tile_c) * (co // 64) == 1056
    assert tfused.dw_fp32_groups(2 * 8 * 25, 64, 16) == 13  # 400 rows
    assert tfused.dw_fp32_groups(13 * 25, 20, 37) == 11     # 325 rows
    assert tfused.dw_fp32_groups(10, 3, 64) == 1


@pytest.mark.parametrize("rows,c,co", [(128 * 300 * 25, 3, 64),
                                       (128 * 75 * 25, 256, 256),
                                       (48 * 13 * 25, 192, 160),
                                       (20 * 11 * 25, 20, 37), (10, 3, 64)])
def test_dw_fp32_groups_are_whole_chunks_within_the_rows(rows, c, co):
    """Each group is a non-empty range of whole 32-row chunks that starts
    inside the rows (none lies past them), and the groups cover every row
    once, in order: the ranges gcn_dw_fp32_kernel computes."""
    chunks = math.ceil(rows / 32)
    groups = tfused.dw_fp32_groups(rows, c, co)
    bounds = [chunks * grp // groups for grp in range(groups + 1)]
    assert bounds[0] == 0 and bounds[-1] == chunks
    assert all(lo < hi and 32 * lo < rows
               for lo, hi in zip(bounds, bounds[1:]))


def test_dw_mma_groups_fill_the_card_within_the_row_chunks():
    """The bf16 dW kernel's groups of 32-row chunks: about 1,056 blocks at
    the training shapes, never more groups than chunks."""
    assert tfused.dw_mma_groups(128 * 300 * 25, 3, 64) == 352
    assert tfused.dw_mma_groups(128 * 75 * 25, 256, 256) == 22
    assert tfused.dw_mma_groups(2 * 8 * 25, 64, 16) == 13  # 400 rows
    assert tfused.dw_mma_groups(10, 3, 64) == 1


@pytest.mark.parametrize("launch", ["launch_gcn_bwd_dw",
                                    "launch_gcn_bwd_da1"])
def test_gcn_bwd_halves_refuse_mixed_dtypes(launch):
    """dW and da1 launched alone check their inputs as the pair does,
    before anything is built or launched."""
    x, a1, w, g = (_t(a, torch.bfloat16) for a in _inputs(8, 16, 16))
    with pytest.raises(TypeError, match="a1 in x's dtype"):
        getattr(tfused, launch)(x, a1.float(), w, g)
    with pytest.raises(ValueError, match="g must be"):
        getattr(tfused, launch)(x, a1, w, g[..., :8].contiguous())


def test_bwd_check_yardsticks_and_work():
    """The card check's library yardsticks compute dW and da1 (fp32, on
    the CPU against the plain version), and the work of the two halves
    adds up to the whole call's operations."""
    from agcn_tpu_torch.tools import bwd_check

    x, a1, w, g = (_t(a) for a in _inputs(6, 16, 24, seed=5))
    want_dw, want_da1 = tfused.gcn_bwd_plain(x, a1, w, g)
    _close(bwd_check.library_dw(torch, x, a1, g).numpy(), want_dw.numpy(),
           1e-4)
    _close(bwd_check.library_da1(torch, x, w, g).numpy(), want_da1.numpy(),
           1e-4)
    half = bwd_check.gcn_bwd_half_work(128, 300, 64, 128, "bfloat16")
    whole = bwd_check.gcn_bwd_work(128, 300, 64, 128, "bfloat16")
    assert 2 * half[0] == whole[0] and half[1] < whole[1] < 2 * half[1]


def test_bwd_check_refuses_without_gpu(capsys):
    """`python -m agcn_tpu_torch.tools.bwd_check` times the card: without
    one it exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from agcn_tpu_torch.tools import bwd_check

    assert bwd_check.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA GPU" in out.err


def test_gcn_bwd_kernel_takes_a1_in_x_dtype():
    """The kernel is built for one dtype across x, a1, W and g: a mixed
    call is refused before anything is launched."""
    x, a1, w, g = (_t(a, torch.bfloat16) for a in _inputs(8, 16, 16))
    with pytest.raises(TypeError, match="a1 in x's dtype"):
        tfused.launch_gcn_bwd(x, a1.float(), w, g)


def test_no_grad_calls_skip_autograd():
    x, a1, w, _ = _inputs(8, 16, 16)
    args = [_t(a, grad=True) for a in (x, a1, w)]
    with torch.no_grad():
        for fn in (tfused.adaptive_gcn_pallas,
                   tfused.adaptive_gcn_pallas_hybrid, tkernel.fused_gcn):
            assert fn(*args).grad_fn is None
    assert tfused.adaptive_gcn_pallas(*args).grad_fn is not None
