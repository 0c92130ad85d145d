"""The port's CUDA kernel on the card (marker `cuda`; skipped without a
GPU). Imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 (TF32 off) 1e-4 of the output's scale — sums of up to
K*V*C products in another order; bf16 one ulp (2^-7 relative) plus 2^-10
of the scale — each output is one bf16 rounding of an fp32 sum.
"""

import math

import numpy as np
import pytest
import torch

from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

pytestmark = pytest.mark.cuda


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


def test_wrappers_count_launches_and_refuse_grad(cuda):
    x, a1, w = _inputs(cuda, 2, 16, 32, 64, torch.float32)
    before = (gcn_fused.adaptive_gcn_pallas.launches,
              gcn_kernel.fused_gcn.launches)
    with torch.no_grad():
        gcn_fused.adaptive_gcn_pallas(x, a1, w)
        gcn_kernel.fused_gcn(x, a1, w)
    assert (gcn_fused.adaptive_gcn_pallas.launches,
            gcn_kernel.fused_gcn.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(RuntimeError, match="training slice"):
        gcn_fused.adaptive_gcn_pallas(x, a1, w.requires_grad_(True))
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
