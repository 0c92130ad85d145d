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


def _exact_inputs(dev, b, t, c, co, v=25, seed=4):
    """bf16 integer inputs on which every sum of the tensor-core path is
    exact in fp32 in any order: x and a1 in [-8, 8] make each aggregate
    an integer of at most 25 * 64 = 1,600; W in [-2, 2] keeps each fp32
    sum of the projection (at most 3 * 200 * 1,600 * 2 here) below 2^22.
    Only the two rounding points (aggregate, y) then decide the result."""
    rng = np.random.default_rng(seed)
    arrs = (rng.integers(-8, 9, (b, t, v, c)),
            rng.integers(-8, 9, (b, 3, v, v)),
            rng.integers(-2, 3, (3, c, co)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev,
                                                           torch.bfloat16)
                 for a in arrs)


# the shapes of test_kernel_matches_plain, a dx-like Co = 3, a last
# 3-frame tile (T = 75, as at l9-l10), and C, Co not multiples of 8 (the
# kernel's element-wise loads and stores)
_MMA_SHAPES = [(48, 16, 32, 25), (50, 64, 64, 25), (24, 128, 128, 25),
               (20, 3, 64, 25), (7, 200, 72, 25), (30, 64, 128, 18),
               (20, 3, 64, 18), (30, 64, 3, 25), (75, 64, 64, 25),
               (11, 20, 37, 25)]


@pytest.mark.parametrize("t,c,co,v", _MMA_SHAPES)
def test_mma_path_bit_exact_on_integer_inputs(cuda, t, c, co, v):
    """bf16 round_agg=1 (the tensor cores' kernel) equals the plain
    version bit for bit where no sum rounds: the aggregate is rounded to
    bf16 exactly where the plain version (and the TPU kernel) rounds it."""
    x, a1, w = _exact_inputs(cuda, 3, t, c, co, v=v)
    got = gcn_fused.launch_gcn_fwd(x, a1, w, True)
    torch.cuda.synchronize()
    want = gcn_fused.gcn_fwd_plain(x, a1, w, True)
    assert got.shape == (3, t, v, co)
    assert torch.equal(got, want)
    assert not torch.equal(got, gcn_fused.gcn_fwd_plain(x, a1, w, False))


@pytest.mark.parametrize("t,c,co", [(75, 256, 256), (30, 64, 3)])
def test_mma_path_is_deterministic(cuda, t, c, co):
    x, a1, w = _inputs(cuda, 4, t, c, co, torch.bfloat16)
    first = gcn_fused.launch_gcn_fwd(x, a1, w, True)
    again = gcn_fused.launch_gcn_fwd(x, a1, w, True)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


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


@pytest.mark.parametrize("t,c,co,v", [(48, 16, 32, 25), (50, 64, 64, 25),
                                      (24, 128, 128, 25), (20, 3, 64, 25),
                                      (7, 200, 72, 25), (30, 64, 128, 18)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_bwd_matches_plain(cuda, t, c, co, v, dtype):
    x, a1, w = _inputs(cuda, 3, t, c, co, dtype, v=v)
    g = _cotangent(cuda, 3, t, co, dtype, v=v)
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    torch.cuda.synchronize()
    assert dw.dtype == dtype and da1.dtype == dtype
    want_dw, want_da1 = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert _close(dw, want_dw) and _close(da1, want_da1)


def _dw_groups(b, t, c, co, dtype, v=25):
    if dtype == torch.bfloat16:
        return gcn_fused.dw_mma_groups(b * t * v, c, co)
    return gcn_fused.dw_groups(b, c, co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_bwd_is_deterministic(cuda, dtype):
    """The dW partials are summed in a fixed order: two calls agree bit
    for bit (the batch spans several groups)."""
    x, a1, w = _inputs(cuda, 64, 40, 64, 64, dtype)
    g = _cotangent(cuda, 64, 40, 64, dtype)
    assert _dw_groups(64, 40, 64, 64, dtype) > 1
    first = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    second = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,t,c,co", [(48, 13, 192, 160), (20, 11, 20, 37)])
def test_gcn_bwd_bf16_spans_row_groups(cuda, b, t, c, co):
    """bf16 dW over groups of 32-row chunks that cut across samples and
    end mid-sample (T*V = 325, 275: not multiples of 32), ragged 64-channel
    tiles of C and Co, and (second case) C and Co off the 8-wide vector
    loads, Co odd: within the bf16 bar of the plain version, and dW and
    da1 launched alone equal the pair."""
    x, a1, w = _inputs(cuda, b, t, c, co, torch.bfloat16)
    g = _cotangent(cuda, b, t, co, torch.bfloat16)
    groups = _dw_groups(b, t, c, co, torch.bfloat16)
    assert groups > 1 and (b * t * 25) % 32
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    torch.cuda.synchronize()
    want_dw, want_da1 = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert _close(dw, want_dw) and _close(da1, want_da1)
    assert torch.equal(gcn_fused.launch_gcn_bwd_dw(x, a1, w, g), dw)
    assert torch.equal(gcn_fused.launch_gcn_bwd_da1(x, a1, w, g), da1)


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


def test_gcn_bwd_rounding_points_in_bf16(cuda):
    """Integer inputs whose every sum is exact in fp32 in any order: the
    kernel equals the plain version bit for bit, and dropping the
    rounding of u (dW) or of p (da1) changes most outputs."""
    rng = np.random.default_rng(3)
    b, t, c, co = 2, 8, 64, 16
    x, a1, w, g = (torch.from_numpy(a.astype(np.float32)).to(
        cuda, torch.bfloat16) for a in (
        rng.integers(-4, 5, (b, t, 25, c)),
        rng.integers(-32, 33, (b, 3, 25, 25)),
        rng.integers(-32, 33, (3, c, co)),
        rng.integers(-32, 33, (b, t, 25, co))))
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    want = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    assert torch.equal(dw, want[0]) and torch.equal(da1, want[1])
    no_u = _unrounded_bwd(x, a1, w, g, False, True)
    no_p = _unrounded_bwd(x, a1, w, g, True, False)
    assert (no_u[0] != dw).float().mean() > 0.2
    assert (no_p[1] != da1).float().mean() > 0.2


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


@pytest.mark.parametrize("b,t,ce", [(32, 300, 16), (8, 75, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_kernel_matches_plain(cuda, b, t, ce, dtype):
    """Two layer shapes of the served AAGCN/AGCN forward (l1-l4 at batch
    32, l9-l10 at batch 8): theta/phi as views of the fused embedding,
    within 1e-5 of the output scale (fp32 sums of T*Ce products in
    another order), two calls and a contiguous copy bitwise equal."""
    from agcn_tpu_torch.ops.kernels import logits_kernel

    g = torch.Generator(device=cuda).manual_seed(4)
    emb = torch.randn(b, t, 25, 6 * ce, device=cuda, generator=g).to(dtype)
    e = emb.view(b, t, 25, 2, 3, ce)
    th, ph = e[..., 0, :, :], e[..., 1, :, :]
    got = logits_kernel.launch_logits(th, ph, ce * t)
    again = logits_kernel.launch_logits(th.contiguous(), ph.contiguous(),
                                        ce * t)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, 3, 25, 25)
    assert torch.equal(got, again)
    want = logits_kernel.attention_logits_plain(th, ph, ce * t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
