"""Port BatchNorm train mode, losses, the SGD chain and its schedule
against agcn_tpu on the CPU, with the same seeded numpy inputs.

Tolerances: BatchNorm fp32 outputs and running statistics atol 1e-5
(sums of another order over 7,500 values); bf16 outputs 2^-7 relative
(one bf16 ulp) plus 2^-10 of the scale; losses 1e-6; the optimizer's
parameters after each of 10 steps 1e-6 relative (fp32 elementwise
updates in the same order, the global norm summed in another).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agcn_tpu import ops as jops
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train import optim as joptim
from agcn_tpu_torch import ops as tops
from agcn_tpu_torch.ops.norm import BatchNorm
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    c = 24
    x = _np(0, 4, 3, 25, c, scale=2.0, shift=0.5)
    scale, bias = _np(1, c), _np(2, c)
    mean, var = _np(3, c), np.abs(_np(4, c)) + 0.5
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, mutated = jops.BatchNorm().apply(
        variables, jnp.asarray(x, jdt), True, mutable=["batch_stats"])
    bn = tops.BatchNorm(c).train()
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                        "running_mean": _t(mean), "running_var": _t(var),
                        "num_batches_tracked": torch.tensor(0)})
    xt = _t(x, tdt).requires_grad_(True)
    got = bn(xt)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    else:
        np.testing.assert_allclose(
            got.detach().float().numpy(), want, rtol=2 ** -7,
            atol=2 ** -10 * np.abs(want).max())
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    # the normalization is differentiated through the batch statistics
    got.float().square().sum().backward()
    assert xt.grad is not None and bn.weight.grad is not None


def test_batchnorm_train_grads_match_jax():
    c = 16
    x = _np(5, 2, 6, 25, c, scale=1.5)
    g = _np(6, 2, 6, 25, c)
    scale, bias = _np(7, c), _np(8, c)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(c, np.float32),
                                 "var": np.ones(c, np.float32)}}

    def f(params, x):
        y, _ = jops.BatchNorm().apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, True, mutable=["batch_stats"])
        return jnp.sum(y * g)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(variables["params"],
                                           jnp.asarray(x))
    bn = tops.BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    xt = _t(x).requires_grad_(True)
    (bn(xt) * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jgp["scale"]), atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jgp["bias"]), atol=1e-4)


def test_batchnorm_unported_options_raise():
    with pytest.raises(NotImplementedError, match="Parallel"):
        BatchNorm(8, axis_name="data")
    # Ghost BN: the batch must divide into the splits
    with pytest.raises(ValueError, match="divisible"):
        BatchNorm(8, splits=2).train()(torch.zeros(3, 4, 8))


@pytest.mark.parametrize("name,kw", [
    ("ce", {}), ("ce", {"smoothing": 0.1}), ("focal", {}),
    ("focal", {"smoothing": 0.1, "alpha": [0.5, 1.0, 2.0, 1.0, 0.25],
               "gamma": 1.5})])
def test_losses_match_jax(name, kw):
    logits = _np(0, 6, 5, scale=2.0)
    labels = np.array([0, 4, 2, 2, 1, 3])
    want = jlosses.build_loss(name, 5, **kw)(jnp.asarray(logits),
                                             jnp.asarray(labels))
    lt = _t(logits).requires_grad_(True)
    got = tlosses.build_loss(name, 5, **kw)(lt, torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    jg = jax.grad(lambda lg: jlosses.build_loss(name, 5, **kw)(
        lg, jnp.asarray(labels)))(jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_unknown_or_unported_training_knobs_raise():
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.build_loss("mmd", 5)
    p = [torch.nn.Parameter(torch.zeros(3))]
    sched = toptim.warmup_step_schedule(0.1, 1, [])
    for name in ("Adam", "AdamW", "SAM_SGD"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            toptim.build_optimizer(name, p, sched)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toptim.build_schedule("onecyclelr", 0.1, 1, [])


def test_warmup_step_schedule_matches_jax():
    args = (0.1, 10, [30, 40], 5)
    want = joptim.warmup_step_schedule(*args)
    got = toptim.warmup_step_schedule(*args)
    for count in (0, 9, 10, 49, 50, 299, 300, 399, 400, 1000):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6)


def test_sgd_chain_matches_optax_over_ten_steps():
    """clip -> L2 decay -> nesterov momentum, the LR from the warmup-step
    schedule at the count before each update; the gradient norm is
    below the clip on some steps and above it on others."""
    shapes = [(4, 3), (7,), (2, 5, 3)]
    init = [_np(10 + i, *s, scale=0.5) for i, s in enumerate(shapes)]
    scales = [0.05, 2.0, 0.1, 5.0, 0.3, 1.5, 0.02, 3.0, 0.6, 8.0]
    noise = [[_np(100 + 10 * k + i, *s) for i, s in enumerate(shapes)]
             for k in range(10)]

    def grads(params, k):
        return [scales[k] * (p + 0.3 * n) for p, n in zip(params, noise[k])]

    sched_args = (0.1, 3, [2], 1)
    tx = joptim.sgd_nesterov(joptim.warmup_step_schedule(*sched_args),
                             weight_decay=1e-4, nesterov=True,
                             grad_clip=1.0)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(_t(p)) for p in init]
    opt = toptim.SGDNesterov(tparams,
                             toptim.warmup_step_schedule(*sched_args),
                             weight_decay=1e-4, nesterov=True,
                             grad_clip=1.0)
    norms = []
    for k in range(10):
        jg = grads([np.asarray(p) for p in jparams], k)
        norms.append(np.sqrt(sum(float((g ** 2).sum()) for g in jg)))
        updates, state = tx.update([jnp.asarray(g) for g in jg], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads([p.detach().numpy()
                                        for p in tparams], k)):
            p.grad = _t(g)
        opt.step()
        for p, want in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    assert min(norms) < 1.0 < max(norms)
    assert opt.count == 10
