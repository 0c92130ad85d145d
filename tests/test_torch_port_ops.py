"""Port ops against agcn_tpu.ops on the CPU: the same inputs, made from a
seed with numpy, through the JAX function and its PyTorch counterpart.

Tolerances: fp32 ops atol 1e-5 (1e-4 for the convolutions: another
summation order over up to 9*C terms); the GCN kernel's plain version
atol 2e-3 against the Pallas kernels in interpret mode, the bar of
tests/test_pallas_gcn.py; bf16 see `_BF16_TOL`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu import ops as jops
from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.ops import initializers as jinit
from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu.ops.pallas import gcn_kernel as jkernel
from agcn_tpu_torch import ops as tops
from agcn_tpu_torch.graph import available_skeletons, build_adjacency
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops import initializers as tinit
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.ops.kernels import gcn_kernel as tkernel
from agcn_tpu_torch.utils.device import resolve_device
from agcn_tpu_torch.utils.weights import conv_to_torch, dense_to_pointwise
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# the test_pallas_gcn.py shapes (t, c, co)
KERNEL_SHAPES = [(48, 16, 32), (50, 64, 64), (24, 128, 128), (20, 3, 64)]
# bf16: each output is one bf16 rounding of an fp32 sum; the two sides
# sum in another order, so an output can land one bf16 ulp (at most 2^-7
# relative) apart: rtol 2^-7, plus atol 2^-10 * |y|max for sums that
# cancel to near zero
_BF16_TOL = 2.0 ** -7


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _gcn_inputs(b=2, t=48, v=25, c=16, k=3, co=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, v, c)).astype(np.float32),
            rng.standard_normal((b, k, v, v)).astype(np.float32),
            rng.standard_normal((k, c, co)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def test_graph_matches_jax():
    from agcn_tpu.graph import build as jbuild
    from agcn_tpu_torch.graph import build as tbuild

    for name in available_skeletons():
        np.testing.assert_array_equal(build_adjacency(name),
                                      jax_build_adjacency(name))
        a = tbuild.edge2mat(tbuild.get_skeleton(name).neighbor,
                            tbuild.get_skeleton(name).num_joints)
        np.testing.assert_array_equal(tbuild.normalize_symmetric(a),
                                      jbuild.normalize_symmetric(a))
    with pytest.raises(ValueError, match="labeling"):
        build_adjacency("ntu_rgb_d", "distance")


@pytest.mark.parametrize("identity", [False, True])
def test_batchnorm_eval_matches_jax(identity):
    c = 24
    x = _np(0, 2, 5, 25, c)
    scale, bias = _np(1, c), _np(2, c)
    mean, var = _np(3, c), np.abs(_np(4, c)) + 0.5
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want = jops.BatchNorm(identity_at_eval=identity).apply(
        variables, jnp.asarray(x), False)
    bn = tops.BatchNorm(c, identity_at_eval=identity).eval()
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                        "running_mean": _t(mean), "running_var": _t(var),
                        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = bn(_t(x))
        got_bf16 = bn(_t(x, torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got_bf16.dtype == torch.bfloat16  # output in x's dtype
    want_bf16 = jops.BatchNorm(identity_at_eval=identity).apply(
        variables, jnp.asarray(x, jnp.bfloat16), False)
    np.testing.assert_allclose(got_bf16.float().numpy(),
                               np.asarray(want_bf16, np.float32),
                               rtol=_BF16_TOL,
                               atol=_BF16_TOL / 8 * np.abs(want).max())


@pytest.mark.parametrize("kernel_size,stride", [(9, 1), (9, 2), (1, 2)])
def test_temporal_conv_matches_jax(kernel_size, stride):
    cin, cout = 16, 24
    x = _np(0, 2, 21, 25, cin)
    kernel = _np(1, kernel_size, 1, cin, cout, scale=0.1)
    bias = _np(2, cout)
    want = jops.TemporalConv(cout, kernel_size=kernel_size,
                             stride=stride).apply(
        {"params": {"conv": {"kernel": kernel, "bias": bias}}},
        jnp.asarray(x))
    conv = tops.TemporalConv(cin, cout, kernel_size, stride)
    conv.load_state_dict({"weight": _t(conv_to_torch(kernel)),
                          "bias": _t(bias)})
    with torch.no_grad():
        got = conv(_t(x))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_pointwise_conv_matches_jax():
    x = _np(0, 2, 7, 25, 16)
    kernel, bias = _np(1, 16, 40, scale=0.1), _np(2, 40)
    want = jops.PointwiseConv(40).apply(
        {"params": {"conv": {"kernel": kernel, "bias": bias}}},
        jnp.asarray(x))
    conv = tops.PointwiseConv(16, 40)
    conv.load_state_dict({"weight": _t(dense_to_pointwise(kernel)),
                          "bias": _t(bias)})
    with torch.no_grad():
        got = conv(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_logits_matches_jax():
    k, ce = 3, 8
    emb = _np(0, 2, 12, 25, 2 * k * ce)
    want = jgcn.attention_logits(jnp.asarray(emb), k, ce, "transposed")
    got = tgcn.attention_logits(_t(emb), k, ce, "transposed")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="unknown attention form"):
        tgcn.attention_logits(_t(emb), k, ce, "nope")


@pytest.mark.parametrize("form", ["agg", "agg_packed", "pallas",
                                  "pallas_hybrid"])
@pytest.mark.parametrize("c", [3, 16])
def test_apply_gcn_matches_jax(form, c):
    x, a1, w = _gcn_inputs(t=24, c=c, co=16)
    want = jgcn.apply_gcn(jnp.asarray(x), jnp.asarray(a1), jnp.asarray(w),
                          form)
    with torch.no_grad():
        got = tgcn.apply_gcn(_t(x), _t(a1), _t(w), form)
    atol = 2e-3 if form.startswith("pallas") else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_apply_gcn_unported_forms_raise():
    x, a1, w = (_t(a) for a in _gcn_inputs(t=8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgcn.apply_gcn(x, a1, w, "pf")
    with pytest.raises(ValueError, match="unknown"):
        tgcn.apply_gcn(x, a1, w, "nope")


@pytest.mark.parametrize("t,c,co", KERNEL_SHAPES)
def test_kernel_plain_matches_jax_pallas_kernels(t, c, co):
    """The kernel's plain version against both Pallas kernels (interpret
    mode), fp32: the two semantics coincide."""
    x, a1, w = _gcn_inputs(t=t, c=c, co=co)
    jx, ja1, jw = jnp.asarray(x), jnp.asarray(a1), jnp.asarray(w)
    want_fused = np.asarray(jfused.adaptive_gcn_pallas(jx, ja1, jw, True))
    want_kernel = np.asarray(jkernel.fused_gcn(jx, ja1, jw, 64, True))
    with torch.no_grad():
        got_fused = tfused.adaptive_gcn_pallas(_t(x), _t(a1), _t(w))
        got_kernel = tkernel.fused_gcn(_t(x), _t(a1), _t(w))
    np.testing.assert_allclose(got_fused.numpy(), want_fused, atol=2e-3)
    np.testing.assert_allclose(got_kernel.numpy(), want_kernel, atol=2e-3)
    np.testing.assert_allclose(
        tkernel.reference_fused_gcn(_t(x), _t(a1), _t(w)).numpy(),
        np.asarray(jkernel.reference_fused_gcn(jx, ja1, jw)), atol=2e-3)
    # on CPU tensors the wrappers take the plain version: no launch
    assert tfused.adaptive_gcn_pallas.launches == 0
    assert tkernel.fused_gcn.launches == 0


@pytest.mark.parametrize("t,c,co", KERNEL_SHAPES)
@pytest.mark.parametrize("round_agg", [True, False])
def test_kernel_plain_bf16_matches_its_jax_kernel(t, c, co, round_agg):
    """bf16: each rounding mode against its own JAX kernel — round_agg
    against gcn_fused (aggregate rounded to bf16), fp32 aggregate against
    gcn_kernel."""
    x, a1, w = _gcn_inputs(t=t, c=c, co=co, seed=1)
    w = w / np.sqrt(3 * c)  # keep |y| near 1 so the bound reads as rel.
    jx, ja1, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, a1, w))
    if round_agg:
        want = jfused.adaptive_gcn_pallas(jx, ja1, jw, True)
    else:
        want = jkernel.fused_gcn(jx, ja1, jw, 64, True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    tx, ta1, tw = (_t(a, torch.bfloat16) for a in (x, a1, w))
    with torch.no_grad():
        got = tfused.gcn_fwd_plain(tx, ta1, tw, round_agg)
        wrong = tfused.gcn_fwd_plain(tx, ta1, tw, not round_agg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=_BF16_TOL,
                               atol=_BF16_TOL / 8 * np.abs(want).max())
    # the bound is tight enough to tell the two rounding modes apart
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(wrong.float().numpy(), want,
                                   rtol=_BF16_TOL,
                                   atol=_BF16_TOL / 8 * np.abs(want).max())


def test_rounding_modes_differ_in_bf16_only():
    x, a1, w = (_t(a) for a in _gcn_inputs(t=16, c=32, co=16, seed=2))
    torch.testing.assert_close(tfused.gcn_fwd_plain(x, a1, w, True),
                               tfused.gcn_fwd_plain(x, a1, w, False),
                               rtol=0, atol=0)
    xb, a1b, wb = (a.to(torch.bfloat16) for a in (x, a1, w))
    assert not torch.equal(tfused.gcn_fwd_plain(xb, a1b, wb, True),
                           tfused.gcn_fwd_plain(xb, a1b, wb, False))


def test_kernel_wrappers_refuse_autograd():
    """The wrappers no longer refuse autograd: with a grad-requiring input
    they run their autograd Function, and without one (or under no_grad)
    the bare forward."""
    x, a1, w = (_t(a) for a in _gcn_inputs(t=8))
    w.requires_grad_(True)
    for fn, function in ((tfused.adaptive_gcn_pallas, "_PallasGCN"),
                         (tkernel.fused_gcn, "_FusedGCN"),
                         (tfused.adaptive_gcn_pallas_hybrid,
                          "_PallasHybridGCN")):
        assert type(fn(x, a1, w).grad_fn).__name__ == function + "Backward"
    with torch.no_grad():
        y = tkernel.fused_gcn(x, a1, w)
    assert y.shape == (2, 8, 25, 32) and y.grad_fn is None


def test_kernel_input_checks():
    x, a1, w = (_t(a) for a in _gcn_inputs(t=8))
    tfused._check(x, a1, w)
    tfused._check(x.bfloat16(), a1, w.bfloat16())  # fp32 a1 with bf16 x
    with pytest.raises(TypeError):
        tfused._check(x, a1, w.bfloat16())
    with pytest.raises(TypeError):
        tfused._check(x, a1.bfloat16(), w)
    with pytest.raises(TypeError):
        tfused._check(x.half(), a1, w.half())
    with pytest.raises(ValueError, match="shape"):
        tfused._check(x, a1[:, :2], w)
    with pytest.raises(ValueError, match="contiguous"):
        tfused._check(x.transpose(1, 2).contiguous().transpose(1, 2),
                      a1, w)
    with pytest.raises(ValueError, match="V="):
        tfused._check(x[:, :, :20], a1[:, :, :20, :20], w)


def test_initializer_statistics_match_jax():
    """Other RNGs: the draws differ, their statistics must not."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    cases = [
        (tinit.kaiming_normal_fan_out, jinit.kaiming_normal_fan_out,
         (256, 128, 9, 1), (9, 1, 128, 256)),
        (tinit.kaiming_normal_fan_out, jinit.kaiming_normal_fan_out,
         (256, 128, 1, 1), (128, 256)),
        (tinit.conv_branch_init(3), jinit.conv_branch_init(3),
         (256, 128, 1, 1), (128, 256)),
        (tinit.fc_init(60), jinit.fc_init(60), (60, 256), (256, 60)),
    ]
    for t_init, j_init, t_shape, j_shape in cases:
        got = t_init(torch.empty(t_shape), g)
        want = np.asarray(j_init(key, j_shape))
        np.testing.assert_allclose(got.std().item(), want.std(), rtol=0.03)
        assert abs(got.mean().item()) < 0.05 * want.std()
    pa = tinit.constant(1e-6)(torch.empty(3, 25, 25), g)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(
        jinit.constant(1e-6)(key, (3, 25, 25))))


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
