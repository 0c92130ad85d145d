"""The port's CUDA kernels on the card (marker `cuda`; skipped without a
GPU): gcn_fwd, gcn_bwd and the attention-logits kernel against their
plain versions, the fused-GCN autograd Functions, AGCN and AAGCN logits
and an AGCN train step against the same on the CPU. Imports
nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 (TF32 off) 1e-4 of the output's scale — sums of up to
K*V*C (forward) or B*T*V*V (backward) products in another order; bf16 one
ulp (2^-7 relative) plus 2^-10 of the scale — each output is one bf16
rounding of an fp32 sum.
"""

import math
import re

import numpy as np
import pytest
import torch

from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def kernels_built():
    """Every CUDA source of the port built before the first test, as
    chip_smoke.py builds them before its first phase. Built later, from
    inside a test (nvcc in a subprocess of this one) after the profiler
    tests had run, the profiler tests that followed saw no kernels of the
    H100 at all (torch 2.11)."""
    if torch.cuda.is_available():
        from agcn_tpu_torch.ops.kernels import build

        build.build_all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, t, c, co, dtype, v=25, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, v, c, device=dev, generator=g)
    a1 = torch.softmax(torch.randn(b, 3, v, v, device=dev, generator=g),
                       dim=-2)
    w = torch.randn(3, c, co, device=dev, generator=g) / math.sqrt(3 * c)
    return x.to(dtype), a1.to(dtype), w.to(dtype)


def _signed_inputs(dev, b, t, c, co, seed=1):
    """bf16 inputs whose two rounding modes differ beyond the bf16 bound.
    x and a1 are signed integers in [-64, 64]: exact in bf16, and every
    aggregate (at most 25 * 64^2 < 2^24) is exact in fp32 in any summation
    order, so kernel and plain version round the same aggregates. Those
    carry 17 significant bits; rounding them to bf16's 8 moves outputs
    near small |y| by more than the bound allows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-64, 65, (b, t, 25, c))
    a1 = rng.integers(-64, 65, (b, 3, 25, 25))
    w = rng.standard_normal((3, c, co)) / np.sqrt(3 * c)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev,
                                                           torch.bfloat16)
                 for a in (x, a1, w))


def _close(got, want):
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    scale = ref.max().item()
    if want.dtype == torch.float32:
        return diff.max().item() <= 1e-4 * scale
    return bool((diff <= 2 ** -7 * ref + 2 ** -10 * scale).all())


@pytest.mark.parametrize("t,c,co,v", [(48, 16, 32, 25), (50, 64, 64, 25),
                                      (24, 128, 128, 25), (20, 3, 64, 25),
                                      (7, 200, 72, 25), (30, 64, 128, 18),
                                      (20, 3, 64, 18)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_agg", [True, False])
def test_kernel_matches_plain(cuda, t, c, co, v, dtype, round_agg):
    x, a1, w = _inputs(cuda, 3, t, c, co, dtype, v=v)
    got = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, t, v, co)
    assert _close(got, gcn_fused.gcn_fwd_plain(x, a1, w, round_agg))


@pytest.mark.parametrize("t,c,co", [(48, 16, 32), (50, 64, 64),
                                    (24, 128, 128), (20, 3, 64)])
def test_kernel_rounding_modes_in_bf16(cuda, t, c, co):
    """Each mode matches the plain version of its own mode and fails the
    other's: a kernel that ignored or inverted round_agg fails here."""
    x, a1, w = _signed_inputs(cuda, 2, t, c, co)
    got = {r: gcn_fused.launch_gcn_fwd(x, a1, w, r) for r in (True, False)}
    torch.cuda.synchronize()
    assert not torch.equal(got[True], got[False])
    for r in (True, False):
        assert _close(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, r))
        assert not _close(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, not r))


def _exact_inputs(dev, b, t, c, co, v=25, seed=4, dtype=torch.bfloat16):
    """Integer inputs (bf16 by default) on which every sum of the kernels
    is exact in fp32 in any order: x and a1 in [-8, 8] make each aggregate
    an integer of at most 25 * 64 = 1,600; W in [-2, 2] keeps each fp32
    sum of the projection (at most 3 * 256 * 1,600 * 2 here) below 2^22.
    Only the rounding points (aggregate, y; none in fp32) then decide the
    result."""
    rng = np.random.default_rng(seed)
    arrs = (rng.integers(-8, 9, (b, t, v, c)),
            rng.integers(-8, 9, (b, 3, v, v)),
            rng.integers(-2, 3, (3, c, co)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                 for a in arrs)


# the shapes of test_kernel_matches_plain, a dx-like Co = 3, a last
# 3-frame tile (T = 75, as at l9-l10), and C, Co not multiples of 8 (the
# kernel's element-wise loads and stores)
_MMA_SHAPES = [(48, 16, 32, 25), (50, 64, 64, 25), (24, 128, 128, 25),
               (20, 3, 64, 25), (7, 200, 72, 25), (30, 64, 128, 18),
               (20, 3, 64, 18), (30, 64, 3, 25), (75, 64, 64, 25),
               (11, 20, 37, 25)]


@pytest.mark.parametrize("round_agg", [True, False])
@pytest.mark.parametrize("t,c,co,v", _MMA_SHAPES)
def test_mma_path_bit_exact_on_integer_inputs(cuda, t, c, co, v, round_agg):
    """bf16 on the tensor cores equals the plain version of its mode bit
    for bit where no sum rounds, and not the other mode's: with round_agg
    the aggregate is rounded to bf16 exactly where the plain version (and
    the TPU kernel) rounds it; without, its hi + lo split (each aggregate
    an integer below 2^17) projects the fp32 aggregate exactly."""
    x, a1, w = _exact_inputs(cuda, 3, t, c, co, v=v)
    got = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
    torch.cuda.synchronize()
    want = gcn_fused.gcn_fwd_plain(x, a1, w, round_agg)
    assert got.shape == (3, t, v, co)
    assert torch.equal(got, want)
    assert not torch.equal(got,
                           gcn_fused.gcn_fwd_plain(x, a1, w, not round_agg))


@pytest.mark.parametrize("round_agg", [True, False])
@pytest.mark.parametrize("t,c,co", [(75, 256, 256), (30, 64, 3)])
def test_mma_path_is_deterministic(cuda, t, c, co, round_agg):
    x, a1, w = _inputs(cuda, 4, t, c, co, torch.bfloat16)
    first = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
    again = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("round_agg", [True, False])
def test_bf16_runs_on_the_tensor_cores_kernel(cuda, round_agg):
    """bf16 x and a1 launch gcn_fwd_mma_kernel in both modes, with the
    split (SPLIT = true) exactly when the aggregate stays fp32, and never
    the CUDA-core gcn_fwd_fp32_kernel."""
    x, a1, w = _inputs(cuda, 2, 12, 64, 64, torch.bfloat16)
    gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "gcn_fwd" in e.name]
    assert names and all("gcn_fwd_mma_kernel" in n for n in names), names
    split = "false" if round_agg else "true"
    assert all(f"{split}>" in n or f"Lb{int(not round_agg)}E" in n
               for n in names), names


# ragged fp32 shapes (t, c, co, v) for gcn_fwd_fp32_kernel: T off its
# frame tile (10 or 5 at V = 25, 14 or 7 at V = 18, 40 or 56 at Co <= 8),
# C off its 16-channel chunk and C = 3, Co = 3 (the 8-channel tile), 37,
# 64, 96 and 256 (the 64- and 128-channel tiles, off the 4-wide stores)
_FP32_SHAPES = [(23, 3, 64, 25), (23, 20, 37, 25), (31, 64, 3, 25),
                (17, 36, 96, 25), (13, 200, 256, 25), (30, 3, 37, 18),
                (45, 20, 64, 18), (61, 64, 3, 18), (9, 36, 96, 18),
                (16, 128, 256, 18)]


@pytest.mark.parametrize("t,c,co,v", _FP32_SHAPES)
def test_fp32_path_bit_exact_on_integer_inputs(cuda, t, c, co, v):
    """fp32 on the CUDA cores equals the plain version bit for bit where
    no sum rounds, in both round_agg modes (one function in fp32)."""
    x, a1, w = _exact_inputs(cuda, 3, t, c, co, v=v, dtype=torch.float32)
    want = gcn_fused.gcn_fwd_plain(x, a1, w, True)
    for round_agg in (True, False):
        got = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
        torch.cuda.synchronize()
        assert got.shape == (3, t, v, co)
        assert torch.equal(got, want)


@pytest.mark.parametrize("t,c,co", [(75, 256, 256), (30, 64, 3)])
def test_fp32_path_is_deterministic(cuda, t, c, co):
    x, a1, w = _inputs(cuda, 4, t, c, co, torch.float32)
    first = gcn_fused.launch_gcn_fwd(x, a1, w, True)
    again = gcn_fused.launch_gcn_fwd(x, a1, w, True)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("round_agg", [True, False])
@pytest.mark.parametrize("t,c,co,v", [(23, 20, 37, 25), (30, 3, 64, 18),
                                      (31, 64, 3, 25), (17, 36, 96, 25)])
def test_bf16_x_with_fp32_a1_matches_plain(cuda, t, c, co, v, round_agg):
    """bf16 x and W with fp32 a1 (no model builds it; the entry point
    takes it): within the bf16 bar of the plain version of each mode."""
    x, a1, w = _inputs(cuda, 3, t, c, co, torch.float32, v=v)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got = gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (3, t, v, co)
    assert _close(got, gcn_fused.gcn_fwd_plain(x, a1, w, round_agg))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_agg", [True, False])
def test_fp32_runs_on_the_cuda_core_kernel(cuda, x_dtype, round_agg):
    """fp32 calls, and bf16 x with fp32 a1, launch gcn_fwd_fp32_kernel
    (of x's type) and nothing else of gcn_fwd.cu."""
    x, a1, w = _inputs(cuda, 2, 12, 64, 64, torch.float32)
    x, w = x.to(x_dtype), w.to(x_dtype)
    gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gcn_fused.launch_gcn_fwd(x, a1, w, round_agg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "gcn_fwd" in e.name]
    assert names and all("gcn_fwd_fp32_kernel" in n for n in names), names
    bf16 = x_dtype == torch.bfloat16
    assert all(("bfloat16" in n) == bf16 for n in names), names


def _launches():
    return (gcn_fused.adaptive_gcn_pallas.launches,
            gcn_kernel.fused_gcn.launches, gcn_fused.gcn_backward.launches)


def test_wrappers_count_launches_and_refuse_grad(cuda):
    """Forward launches count one each; with grad, 'pallas' launches
    gcn_fwd again for dx and gcn_bwd once. Tensors on two devices are
    refused."""
    x, a1, w = _inputs(cuda, 2, 16, 32, 64, torch.float32)
    before = _launches()
    with torch.no_grad():
        gcn_fused.adaptive_gcn_pallas(x, a1, w)
        gcn_kernel.fused_gcn(x, a1, w)
    assert _launches() == (before[0] + 1, before[1] + 1, before[2])
    gcn_fused.adaptive_gcn_pallas(x.requires_grad_(True), a1,
                                  w.requires_grad_(True)).sum().backward()
    assert _launches() == (before[0] + 3, before[1] + 1, before[2] + 1)
    with pytest.raises(ValueError, match="devices"):
        gcn_kernel.fused_gcn(x, a1.cpu(), w.detach())


def test_launch_keeps_the_current_device(cuda):
    """A launch on the last card leaves the caller's current device (the
    first) as it was; with one card the two are the same."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    x, a1, w = _inputs(last, 1, 8, 16, 64, torch.float32)
    torch.cuda.set_device(0)
    gcn_fused.launch_gcn_fwd(x, a1, w, True)
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("kw", [{"formulation": "pallas"},
                                {"use_pallas": True}])
def test_agcn_on_card_matches_cpu(cuda, kw):
    adj = build_adjacency("ntu_rgb_d")
    card = AGCN(num_class=7, adj=adj, device=cuda, **kw).eval()
    cpu = AGCN(num_class=7, adj=adj, device="cpu", **kw).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 40, 25, 2)).astype(np.float32)
    with torch.no_grad():
        got = card(torch.from_numpy(x).to(cuda)).cpu()
        want = cpu(torch.from_numpy(x))
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def _cotangent(dev, b, t, co, dtype, v=25, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(b, t, v, co, device=dev, generator=g).to(dtype)


# with a ragged last 4-frame tile (T = 37) at V = 25 and 18, and C = 3
@pytest.mark.parametrize("t,c,co,v", [(48, 16, 32, 25), (50, 64, 64, 25),
                                      (24, 128, 128, 25), (20, 3, 64, 25),
                                      (7, 200, 72, 25), (30, 64, 128, 18),
                                      (37, 64, 96, 25), (37, 3, 64, 18)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_bwd_matches_plain(cuda, t, c, co, v, dtype):
    x, a1, w = _inputs(cuda, 3, t, c, co, dtype, v=v)
    g = _cotangent(cuda, 3, t, co, dtype, v=v)
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    torch.cuda.synchronize()
    assert dw.dtype == dtype and da1.dtype == dtype
    want_dw, want_da1 = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert _close(dw, want_dw) and _close(da1, want_da1)


def _da1_groups(b, t, c, dtype, v=25):
    """The frame groups of the da1 launch, over the library's tiles."""
    frames = gcn_fused.da1_tiling(v, c, dtype == torch.bfloat16)[0]
    return gcn_fused.da1_groups(b, t, frames)


def _dw_groups(b, t, c, co, dtype, v=25):
    if dtype == torch.bfloat16:
        return gcn_fused.dw_mma_groups(b * t * v, c, co)
    return gcn_fused.dw_fp32_groups(b * t * v, c, co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_bwd_is_deterministic(cuda, dtype):
    """The dW and da1 partials are summed in a fixed order: two calls
    agree bit for bit (the batch spans several dW groups, each sample
    several da1 frame groups)."""
    x, a1, w = _inputs(cuda, 64, 40, 64, 64, dtype)
    g = _cotangent(cuda, 64, 40, 64, dtype)
    assert _dw_groups(64, 40, 64, 64, dtype) > 1
    assert _da1_groups(64, 40, 64, dtype) > 1
    first = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    second = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,t,c,co", [(48, 13, 192, 160), (20, 11, 20, 37)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gcn_bwd_spans_row_groups(cuda, b, t, c, co, dtype):
    """dW over groups of 32-row chunks that cut across samples and end
    mid-sample (T*V = 325, 275: not multiples of 32), bf16 da1 over frame
    groups whose last 4-frame tile is ragged (T = 13, 11), ragged
    64-channel tiles of C and Co, and (second case) C and Co off the
    vector loads (8-wide in bf16, 4-wide in fp32), Co odd: within the
    bar of the plain version, and dW and da1 launched alone equal the
    pair."""
    x, a1, w = _inputs(cuda, b, t, c, co, dtype)
    g = _cotangent(cuda, b, t, co, dtype)
    groups = _dw_groups(b, t, c, co, dtype)
    assert groups > 1 and (b * t * 25) % 32
    assert gcn_fused.da1_groups(b, t) > 1 and t % 4
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    torch.cuda.synchronize()
    want_dw, want_da1 = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert _close(dw, want_dw) and _close(da1, want_da1)
    assert torch.equal(gcn_fused.launch_gcn_bwd_dw(x, a1, w, g), dw)
    assert torch.equal(gcn_fused.launch_gcn_bwd_da1(x, a1, w, g), da1)


# (b, t, c, co, v): the C = 3 entry layer (the 8-channel C tile) at a
# ragged T, C and Co off the 4-wide loads at V = 18, a 64-channel
# layer, and two C and Co tiles; each spans several row groups
@pytest.mark.parametrize("b,t,c,co,v", [(3, 37, 3, 64, 25),
                                        (3, 13, 20, 37, 18),
                                        (2, 20, 64, 64, 25),
                                        (2, 11, 128, 96, 25)])
def test_gcn_bwd_fp32_dw_bit_for_bit_on_integers(cuda, b, t, c, co, v):
    """fp32 integer inputs whose every dW sum is exact in fp32 in any
    order (sum |x| |u| < 2^24, checked): the CUDA-core GEMM over u formed
    once equals gcn_dw_plain bit for bit."""
    rng = np.random.default_rng(6)
    x, a1, g = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.integers(-4, 5, (b, t, v, c)),
        rng.integers(-8, 9, (b, 3, v, v)),
        rng.integers(-8, 9, (b, t, v, co))))
    w = torch.zeros(3, c, co, device=cuda)
    assert gcn_fused.dw_fp32_groups(b * t * v, c, co) > 1
    assert gcn_fused.gcn_dw_plain(x.abs(), a1.abs(), g.abs()).max() < 2 ** 24
    dw = gcn_fused.launch_gcn_bwd_dw(x, a1, w, g)
    torch.cuda.synchronize()
    assert torch.equal(dw, gcn_fused.gcn_dw_plain(x, a1, g))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dw_runs_u_then_the_gemm_of_its_dtype(cuda, dtype):
    """dW launches gcn_u_kernel, then gcn_dw_mma_kernel (bf16) or the
    CUDA-core gcn_dw_fp32_kernel (fp32), then the ordered reduce."""
    x, a1, w = _inputs(cuda, 2, 12, 64, 64, dtype)
    g = _cotangent(cuda, 2, 12, 64, dtype)
    gcn_fused.launch_gcn_bwd_dw(x, a1, w, g)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gcn_fused.launch_gcn_bwd_dw(x, a1, w, g)
        torch.cuda.synchronize()
    kinds = ("gcn_u_kernel", "gcn_dw_mma_kernel", "gcn_dw_fp32_kernel",
             "gcn_dw_reduce_kernel")
    found = {k for k in kinds if any(k in e.name for e in prof.events())}
    gemm = ("gcn_dw_mma_kernel" if dtype == torch.bfloat16
            else "gcn_dw_fp32_kernel")
    assert found == {"gcn_u_kernel", gemm, "gcn_dw_reduce_kernel"}, found


def _unrounded_bwd(x, a1, w, g, round_u, round_p):
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


# (b, t, c, co, v, shows): the case of PR 2, where dropping either
# rounding changes most outputs; then bit for bit alone at a ragged T
# (37) with C, Co off the 64-channel chunks at V = 18, and at the C = 3
# entry layer (sums over more terms, whose rounding errors may cancel)
@pytest.mark.parametrize("b,t,c,co,v,shows", [(2, 8, 64, 16, 25, True),
                                              (2, 37, 96, 72, 18, False),
                                              (3, 37, 3, 64, 25, False)])
def test_gcn_bwd_rounding_points_in_bf16(cuda, b, t, c, co, v, shows):
    """Integer inputs whose every sum is exact in fp32 in any order: the
    kernel equals the plain version bit for bit, and dropping the
    rounding of u (dW) or of p (da1) changes most outputs. Each sample's
    da1 spans several frame groups."""
    rng = np.random.default_rng(3)
    x, a1, w, g = (torch.from_numpy(a.astype(np.float32)).to(
        cuda, torch.bfloat16) for a in (
        rng.integers(-4, 5, (b, t, v, c)),
        rng.integers(-32, 33, (b, 3, v, v)),
        rng.integers(-32, 33, (3, c, co)),
        rng.integers(-32, 33, (b, t, v, co))))
    assert gcn_fused.da1_groups(b, t) > 1
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    want = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert torch.equal(dw, want[0]) and torch.equal(da1, want[1])
    if shows:
        no_u = _unrounded_bwd(x, a1, w, g, False, True)
        no_p = _unrounded_bwd(x, a1, w, g, True, False)
        assert (no_u[0] != dw).float().mean() > 0.2
        assert (no_p[1] != da1).float().mean() > 0.2


# (b, t, c, co, v): T off the 5- and 7-frame tiles, the C = 3 entry
# layer (4-channel chunks), C = 20 (a ragged 16-channel chunk), Co = 37
# (off the 64-channel chunk and the 4-wide copies) and 96 (two chunks,
# the second ragged), V = 18
_DA1_FP32_SHAPES = [(3, 37, 3, 64, 25), (3, 13, 20, 37, 18),
                    (2, 23, 20, 96, 25), (2, 30, 64, 96, 18),
                    (4, 11, 128, 37, 25)]


@pytest.mark.parametrize("b,t,c,co,v", _DA1_FP32_SHAPES)
def test_gcn_bwd_fp32_da1_matches_plain(cuda, b, t, c, co, v):
    """Random fp32 inputs: gcn_da1_fp32_kernel over several frame groups,
    then the ordered reduce, within the fp32 bar of the plain version,
    and two calls bitwise equal."""
    x, a1, w = _inputs(cuda, b, t, c, co, torch.float32, v=v)
    g = _cotangent(cuda, b, t, co, torch.float32, v=v)
    assert _da1_groups(b, t, c, torch.float32, v) > 1
    da1 = gcn_fused.launch_gcn_bwd_da1(x, a1, w, g)
    torch.cuda.synchronize()
    assert _close(da1, gcn_fused.gcn_da1_plain(x, w, g))
    assert torch.equal(gcn_fused.launch_gcn_bwd_da1(x, a1, w, g), da1)


@pytest.mark.parametrize("b,t,c,co,v", _DA1_FP32_SHAPES)
def test_gcn_bwd_fp32_da1_bit_for_bit_on_integers(cuda, b, t, c, co, v):
    """fp32 x, W and g integers in [-1, 1] (a1 anything): every sum is
    exact in fp32 in any order (sum |p| |g| < 2^24, checked), so the
    kernel equals gcn_da1_plain bit for bit."""
    rng = np.random.default_rng(7)
    x, w, g = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.integers(-1, 2, (b, t, v, c)), rng.integers(-1, 2, (3, c, co)),
        rng.integers(-1, 2, (b, t, v, co))))
    a1 = torch.randn(b, 3, v, v, device=cuda)
    assert _da1_groups(b, t, c, torch.float32, v) > 1
    assert gcn_fused.gcn_da1_plain(x.abs(), w.abs(), g.abs()).max() < 2 ** 24
    da1 = gcn_fused.launch_gcn_bwd_da1(x, a1, w, g)
    torch.cuda.synchronize()
    assert torch.equal(da1, gcn_fused.gcn_da1_plain(x, w, g))


@pytest.mark.parametrize("v", [25, 18])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_da1_tiling_fits_two_blocks_an_sm(cuda, dtype, v):
    """The library's da1 tiling: 5- or 7-frame tiles in fp32 (128 rows of
    (t, v) at most), 4 in bf16, and an SM of this card holds two blocks
    at both C chunks (the kernels' __launch_bounds__(256, 2))."""
    bf16 = dtype == torch.bfloat16
    for c in (3, 64):
        frames, smem, blocks = gcn_fused.da1_tiling(v, c, bf16)
        assert frames == (4 if bf16 else 128 // v)
        assert blocks >= 2 and 0 < 2 * smem <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_da1_runs_on_the_tensor_cores_kernel(cuda, dtype):
    """bf16 da1 launches gcn_da1_mma_kernel and its ordered reduce, never
    the CUDA-core gcn_da1_fp32_kernel; fp32 da1 launches
    gcn_da1_fp32_kernel and the ordered reduce, never the tensor cores'
    kernel (nor the removed gcn_da1_kernel)."""
    x, a1, w = _inputs(cuda, 2, 12, 64, 64, dtype)
    g = _cotangent(cuda, 2, 12, 64, dtype)
    gcn_fused.launch_gcn_bwd_da1(x, a1, w, g)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gcn_fused.launch_gcn_bwd_da1(x, a1, w, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "gcn_da1" in e.name]
    want = ({"gcn_da1_mma_kernel", "gcn_da1_reduce_kernel"}
            if dtype == torch.bfloat16 else
            {"gcn_da1_fp32_kernel", "gcn_da1_reduce_kernel"})
    found = {k for k in ("gcn_da1_mma_kernel", "gcn_da1_reduce_kernel",
                         "gcn_da1_fp32_kernel", "gcn_da1_kernel")
             if any(k in n for n in names)}
    assert found == want, names


_FORMS = {"pallas": gcn_fused.adaptive_gcn_pallas,
          "pallas_hybrid": gcn_fused.adaptive_gcn_pallas_hybrid,
          "fused_gcn": gcn_kernel.fused_gcn}


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c,co", [(40, 32, 16), (30, 3, 64)])
def test_autograd_functions_match_the_cpu(cuda, form, dtype, t, c, co):
    """Value and the grads of x, a1 and W on the card (kernels) against
    the same Function on the CPU (plain versions)."""
    fn = _FORMS[form]
    args = _inputs(cuda, 2, t, c, co, dtype)
    g = _cotangent(cuda, 2, t, co, dtype)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args]
        y = fn(*leaves)
        y.backward(g.to(dev))
        outs.append([y.detach()] + [a.grad for a in leaves])
    (y, *grads), (want_y, *want_grads) = outs
    assert _close(y.cpu(), want_y)
    # the grads at the CPU tests' bars (tests/test_torch_port_grad.py):
    # the einsum cotangents round their intermediates to bf16 as well
    rel = 1e-4 if dtype == torch.float32 else 2 ** -6
    for got, want in zip(grads, want_grads):
        assert got.dtype == want.dtype
        scale = want.float().abs().max().item()
        assert (got.cpu().float() - want.float()).abs().max().item() \
            <= rel * scale


@pytest.mark.parametrize("form", ["pallas", "pallas_hybrid", "agg_packed"])
def test_agcn_train_step_on_card_matches_cpu(cuda, form):
    """One step on the card against the CPU's, the card replaying the
    CPU's ReLU masks (agcn_tpu_torch/tools/grad_parity.py), its ReLU
    inputs within 1e-3 of their layer's mean |input| of the CPU's: loss
    1e-4 relative, every gradient within `grad_errors`' bar at 1e-3, the
    updated state 2e-4."""
    from agcn_tpu_torch.tools.grad_parity import (ReluProbe, condition_bn,
                                                  grad_errors, relu_probe)
    from agcn_tpu_torch.train import losses, optim
    from agcn_tpu_torch.train.steps import make_train_step

    adj = build_adjacency("ntu_rgb_d")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 40, 25, 2)).astype(np.float32)
    y = np.array([1, 5])
    out = {}
    state = cpu_probe = None
    for dev in (torch.device("cpu"), cuda):
        model = AGCN(num_class=7, adj=adj, device=dev, formulation=form)
        if state is None:
            condition_bn(model, 0)
            # copies: the CPU step updates the model's tensors in place
            state = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        raw = {}
        opt = optim.SGDNesterov(model.parameters(),
                                optim.warmup_step_schedule(0.1, 1, []))
        step = make_train_step(
            model, losses.cross_entropy, opt,
            grad_transform=lambda m: raw.update(
                (n, p.grad.double().cpu().clone())
                for n, p in m.named_parameters()))
        probe = ReluProbe(ref=cpu_probe, keep_inputs=cpu_probe is None)
        with relu_probe(probe):
            m = step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        cpu_probe = cpu_probe or probe
        out[dev.type] = (m["loss"].item(), raw, {
            k: v.cpu() for k, v in model.state_dict().items()})
    (loss, grads, after), (ref_loss, ref_grads, ref_after) = \
        out["cuda"], out["cpu"]
    assert probe.input_diff <= 1e-3
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    worst = grad_errors(grads, ref_grads, 1e-3)[0]
    assert worst[0] <= 1.0, worst
    for name, want in ref_after.items():
        torch.testing.assert_close(after[name], want, atol=2e-4, rtol=0,
                                   msg=name)


def _logits_views(dev, b, t, v, ce, dtype, seed, integers=False):
    """theta, phi (B, T, V, 3, Ce) as views of a fused (B, T, V, 6 Ce)
    embedding: normal, or integers in [-2, 2]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, v, 6 * ce)
    emb = (torch.randint(-2, 3, shape, device=dev, generator=g) if integers
           else torch.randn(shape, device=dev, generator=g)).to(dtype)
    e = emb.view(b, t, v, 2, 3, ce)
    return e[..., 0, :, :], e[..., 1, :, :]


# (B, T, V, Ce): two layer shapes of the served AAGCN/AGCN forward (l1-l4
# at batch 32, many spans; l9-l10 at batch 8); V = 18, 15 and 7 (the
# fp32 tile of V = 18, the general one); Ce = 12 (24-byte bf16 rows: 4-
# byte copies) and 300 (frames in two parts); one span at (2, 20, 7, 12)
@pytest.mark.parametrize("b,t,v,ce", [(32, 300, 25, 16), (8, 75, 25, 64),
                                      (3, 37, 18, 16), (3, 29, 15, 12),
                                      (2, 20, 7, 12), (2, 9, 25, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_kernel_matches_plain(cuda, b, t, v, ce, dtype):
    """theta/phi as views of the fused embedding: within 1e-5 of the
    output scale (fp32 sums of T*Ce products in another order); two calls,
    a contiguous copy and a theta whose channel stride is not 1 bitwise
    equal (the copies differ, the order of the sums does not); on integer
    inputs the sums (divisor 1) equal to the plain version's bit for bit
    and the logits those sums divided once (on the card PyTorch divides
    by a Python number through its fp32 reciprocal, so the plain version
    is held at divisor 1)."""
    from agcn_tpu_torch.ops.kernels import logits_kernel

    th, ph = _logits_views(cuda, b, t, v, ce, dtype, 4)
    got = logits_kernel.launch_logits(th, ph, ce * t)
    again = logits_kernel.launch_logits(th.contiguous(), ph.contiguous(),
                                        ce * t)
    strided = th.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert strided.stride(-1) != 1
    third = logits_kernel.launch_logits(strided, ph, ce * t)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, 3, v, v)
    assert torch.equal(got, again) and torch.equal(got, third)
    want = logits_kernel.attention_logits_plain(th, ph, ce * t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    th, ph = _logits_views(cuda, b, t, v, ce, dtype, 5, integers=True)
    sums = logits_kernel.launch_logits(th, ph, 1.0)
    assert torch.equal(sums, logits_kernel.attention_logits_plain(th, ph,
                                                                  1.0))
    got = logits_kernel.launch_logits(th, ph, ce * t)
    assert torch.equal(got, sums / torch.full_like(sums, ce * t))
    plan = logits_kernel.launch_plan(b, t, 3, ce, dtype)
    assert plan["spans"] > 1 if b == 32 else True
    assert plan["spans"] == 1 if (b, v) == (2, 7) else True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_runs_the_kernel_of_its_dtype(cuda, dtype):
    """bf16 launches logits_mma_kernel (the tensor cores), fp32
    logits_fp32_kernel (the CUDA cores), each then the span reduce."""
    from agcn_tpu_torch.ops.kernels import logits_kernel

    th, ph = _logits_views(cuda, 32, 300, 25, 16, dtype, 6)
    logits_kernel.launch_logits(th, ph, 4800.0)  # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits_kernel.launch_logits(th, ph, 4800.0)
        torch.cuda.synchronize()
    names = {m.group(0) for e in prof.events()
             for m in [re.search(r"logits_(mma|fp32|reduce)_kernel", e.name)]
             if m}
    main = ("logits_mma_kernel" if dtype == torch.bfloat16
            else "logits_fp32_kernel")
    assert names == {main, "logits_reduce_kernel"}, names


def test_logits_on_a_side_stream_matches(cuda):
    """The spans' sums go through a buffer kept for each device and
    stream: calls on a side stream, and a larger call after a smaller one,
    give what the default stream gives, bitwise."""
    from agcn_tpu_torch.ops.kernels import logits_kernel

    small = _logits_views(cuda, 8, 75, 25, 64, torch.bfloat16, 7)
    big = _logits_views(cuda, 32, 300, 25, 16, torch.bfloat16, 8)
    want = [logits_kernel.launch_logits(*x, 100.0) for x in (small, big)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [logits_kernel.launch_logits(*x, 100.0) for x in (small, big)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_logits_wrapper_counts_launches(cuda):
    from agcn_tpu_torch.ops.kernels import logits_kernel

    th = torch.randn(2, 10, 25, 3, 8, device=cuda)
    before = logits_kernel.attention_logits_pallas.launches
    logits_kernel.attention_logits_pallas(th, th, 80)
    logits_kernel.attention_logits_pallas(th.cpu(), th.cpu(), 80)
    assert logits_kernel.attention_logits_pallas.launches == before + 1
    with pytest.raises(ValueError, match="devices"):
        logits_kernel.attention_logits_pallas(th, th.cpu(), 80)


@pytest.mark.parametrize("kw", [{"formulation": "pallas",
                                 "eval_formulation": "pallas"}, {}])
def test_aagcn_on_card_matches_cpu(cuda, kw):
    """The full-depth AAGCN with a live attention branch and BN statistics
    taken from a train-mode forward: card logits within 1e-4 of the logit
    scale of the CPU's (fp32, TF32 off, sums in another order)."""
    from agcn_tpu_torch.models.aagcn import AAGCN
    from agcn_tpu_torch.ops.norm import BatchNorm

    adj = build_adjacency("ntu_rgb_d")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 40, 25, 2)).astype(np.float32))
    card = AAGCN(num_class=7, adj=adj, device=cuda, **kw)
    g = torch.Generator().manual_seed(1)
    norms = [m for m in card.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for name, p in card.named_parameters():
            if name.endswith(".alpha") or name.endswith("bn.weight"):
                p.copy_((torch.rand(p.shape, generator=g) + 0.5).to(cuda))
            elif ".conv_ta." in name or ".fc2c." in name:
                p.copy_((torch.randn(p.shape, generator=g) * 0.1).to(cuda))
        for m in norms:
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        card.train()(x.to(cuda))
        for m in norms:  # the batch statistics of that forward
            m.running_mean.div_(0.1)
            m.running_var.sub_(0.9).div_(0.1).clamp_(min=1e-3)
    cpu = AAGCN(num_class=7, adj=adj, device="cpu", **kw).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    with torch.no_grad():
        got = card.eval()(x.to(cuda)).cpu()
        want = cpu(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
