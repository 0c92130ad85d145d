"""Port BatchNorm train mode, losses, the optimizers (SGD nesterov, Adam,
AdamW, the LLRD multipliers) and the schedules (warmup + step, onecycle,
cyclic) against agcn_tpu on the CPU, with the same seeded numpy inputs.

Tolerances: BatchNorm fp32 outputs and running statistics atol 1e-5
(sums of another order over 7,500 values); bf16 outputs 2^-7 relative
(one bf16 ulp) plus 2^-10 of the scale; losses 1e-6; the optimizer's
parameters after each of 10 steps 1e-6 relative (fp32 elementwise
updates in the same order, the global norm summed in another); the
schedules 1e-6 relative (optax computes them in fp32, the port in
double).
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
    # SyncBN outside a mapped axis: eval mode normalizes with the running
    # statistics, train mode raises JAX's NameError for an unbound axis
    x = np.random.default_rng(0).standard_normal((3, 4, 8)).astype(
        np.float32)
    jbn = jops.BatchNorm(axis_name="data")
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    with pytest.raises(NameError, match="unbound axis name: data"):
        jbn.apply(variables, jnp.asarray(x), train=True,
                  mutable=["batch_stats"])
    bn = BatchNorm(8, axis_name="data")
    np.testing.assert_allclose(
        bn.eval()(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jbn.apply(variables, jnp.asarray(x), train=False)),
        atol=1e-6)
    with pytest.raises(NameError, match="unbound axis name: data"):
        bn.train()(torch.from_numpy(x))
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
    """The names agcn_tpu's factories refuse raise here too; the SAM names
    are SGD nesterov (agcn_tpu optim.py:123-124), SAM's second pass being
    the train step's (tests/test_torch_port_sam_scan.py)."""
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.build_loss("mmd", 5)
    p = [torch.nn.Parameter(torch.zeros(3))]
    sched = toptim.warmup_step_schedule(0.1, 1, [])
    for name in ("SAM_SGD", "SAM", "sam"):
        opt = toptim.build_optimizer(name, p, sched, weight_decay=1e-3,
                                     nesterov=False)
        assert type(opt) is toptim.SGDNesterov
        group = opt.opt.param_groups[0]
        assert (group["momentum"], group["nesterov"],
                group["weight_decay"]) == (0.9, False, 1e-3)
        joptim.build_optimizer(name, 0.1)  # agcn_tpu builds them too
    # as agcn_tpu's factory: no Adam-LLRD
    with pytest.raises(ValueError, match="Unknown optimizer"):
        toptim.build_optimizer("Adam-LLRD", p, sched)


def test_sam_perturbation_matches_jax():
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (7,), ())]
    grads = [rng.standard_normal(x.shape).astype(np.float32)
             for x in params]
    grads[1][:] = 0.0  # an unused parameter's zero gradient
    want = joptim.sam_perturbation([jnp.asarray(g) for g in grads],
                                   [jnp.asarray(x) for x in params], 0.05)
    got = toptim.sam_perturbation([torch.from_numpy(x) for x in params],
                                  [torch.from_numpy(g) for g in grads], 0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    assert np.abs(got[0].numpy() - params[0]).max() > 1e-3
    np.testing.assert_array_equal(got[1].numpy(), params[1])


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


# names as the port's transformer names its parameters: two encoders'
# layer1 / layer2 share a multiplier, nothing else matches `layer<N>`
_NAMED = [("temporal_encoder.layer1.self_attn.in_proj_weight", (6, 3)),
          ("spatial_encoder.layer2.linear1.weight", (7,)),
          ("l1.gcn1.conv_d.0.weight", (2, 5, 3)),
          ("temporal_encoder.layer2.norm1.bias", (3,)),
          ("spatial_encoder.layer1.linear1.bias", (4, 2)),
          ("cross_fusion.a_attends_b1.to_q.weight", (5,))]


@pytest.mark.parametrize("name,llrd", [("Adam", 1.0), ("AdamW", 1.0),
                                       ("SGD-LLRD", 0.8),
                                       ("AdamW-LLRD", 0.8)])
def test_optimizers_match_optax_over_ten_steps(name, llrd):
    """agcn_tpu's build_optimizer (and with_llrd) against the port's
    factory with `llrd_scales`, the LR from onecycle at the count before
    each update, weight decay 1e-2; the gradient norm below the clip on
    some steps and above it on others."""
    names = [n for n, _ in _NAMED]
    init = [_np(20 + i, *s, scale=0.5) for i, (_, s) in enumerate(_NAMED)]
    scales = [0.05, 2.0, 0.1, 5.0, 0.3, 1.5, 0.02, 3.0, 0.6, 8.0]
    noise = [[_np(200 + 10 * k + i, *s) for i, (_, s) in enumerate(_NAMED)]
             for k in range(10)]
    sched_args = (0.01, 3, 3, 1, 1e-4, 1e-6)
    jparams = {n: jnp.asarray(p) for n, p in zip(names, init)}
    tx = joptim.build_optimizer(name, joptim.onecycle_schedule(*sched_args),
                                1e-2)
    if "LLRD" in name.upper():
        tx = joptim.with_llrd(tx, jparams, llrd)
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(_t(p)) for p in init]
    lr_scales = (toptim.llrd_scales(names, llrd) if "LLRD" in name.upper()
                 else None)
    opt = toptim.build_optimizer(name, tparams,
                                 toptim.onecycle_schedule(*sched_args),
                                 1e-2, lr_scales=lr_scales)
    if lr_scales:
        assert lr_scales == [0.8, 1.0, 1.0, 1.0, 0.8, 1.0]
    norms = []
    for k in range(10):
        jg = {n: scales[k] * (np.asarray(jparams[n]) + 0.3 * noise[k][i])
              for i, n in enumerate(names)}
        norms.append(np.sqrt(sum(float((g ** 2).sum())
                                 for g in jg.values())))
        updates, state = tx.update({n: jnp.asarray(g) for n, g in jg.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for i, p in enumerate(tparams):
            p.grad = _t(scales[k] * (p.detach().numpy() + 0.3 * noise[k][i]))
        opt.step()
        for p, n in zip(tparams, names):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {k} {n}")
    assert min(norms) < 1.0 < max(norms)
    assert opt.count == 10


def test_optimizer_state_round_trips(tmp_path):
    """Adam's moments and count through state_dict and a file: ten steps
    equal five, a save, a load into a fresh optimizer, and five more; an
    SGD state under the older key loads."""
    init = [_np(40 + i, *s) for i, (_, s) in enumerate(_NAMED)]
    grads = [[_np(300 + 10 * k + i, *s) for i, (_, s) in enumerate(_NAMED)]
             for k in range(10)]
    sched = toptim.cyclic_schedule(0.01, 4)

    def run(params, opt, steps):
        for k in steps:
            for p, g in zip(params, grads[k]):
                p.grad = _t(g)
            opt.step()

    def adamw(params):
        return toptim.build_optimizer("AdamW", params, sched, 1e-2)

    whole = [torch.nn.Parameter(_t(p)) for p in init]
    run(whole, adamw(whole), range(10))
    parts = [torch.nn.Parameter(_t(p)) for p in init]
    opt = adamw(parts)
    run(parts, opt, range(5))
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    again = adamw(parts)
    again.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert again.count == 5
    run(parts, again, range(5, 10))
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    # an SGD state saved before the port had Adam, under the key "sgd"
    sgd = toptim.build_optimizer("SGD", whole, sched)
    run(whole, sgd, range(3))
    old = {"count": 3, "sgd": sgd.state_dict()["opt"]}
    loaded = toptim.build_optimizer("SGD", whole, sched)
    loaded.load_state_dict(old)
    assert loaded.count == 3
    for i, st in sgd.opt.state_dict()["state"].items():
        assert torch.equal(loaded.opt.state_dict()["state"][i]
                           ["momentum_buffer"], st["momentum_buffer"])


@pytest.mark.parametrize("args", [
    (0.001, 10, 60, 5, 1e-5, 1e-7),   # the transformer recipe's numbers
    (0.001, 10, 60, 5, None, None),   # base / 25 up, base / 1e4 down
    (0.1, 7, 3, 1, None, 1e-4),
    (0.05, 3, 4, 0, 2e-3, None)],     # pct_start 1e-3 -> 0.012: no warm-up
    ids=["recipe", "defaults", "final_only", "initial_only"])
def test_onecycle_schedule_matches_optax(args):
    want = joptim.onecycle_schedule(*args)
    if args[3] == 0 and int(1e-3 * args[1] * args[2]) == 0:
        # optax's first interval is empty: NaN at every count; the port
        # refuses
        assert np.isnan(float(want(jnp.asarray(0))))
        with pytest.raises(ValueError, match="empty interval"):
            toptim.onecycle_schedule(*args)
        return
    got = toptim.onecycle_schedule(*args)
    total = args[1] * args[2]
    peak = int(max(args[3] / args[2], 1e-3) * total)
    for count in sorted({0, 1, peak - 1, peak, peak + 1, total // 2,
                         total - 1, total, total + 1, 10 * total}):
        np.testing.assert_allclose(got(count),
                                   float(want(jnp.asarray(count))),
                                   rtol=1e-6, err_msg=f"count {count}")


@pytest.mark.parametrize("mode", ["triangular", "triangular2"])
@pytest.mark.parametrize("steps_per_epoch", [1, 5, 8])
def test_cyclic_schedule_matches_jax(mode, steps_per_epoch):
    want = joptim.cyclic_schedule(0.05, steps_per_epoch, mode)
    got = toptim.cyclic_schedule(0.05, steps_per_epoch, mode)
    up = max(steps_per_epoch // 2, 1)
    cycle = up + max(steps_per_epoch - up, 1)
    for count in sorted({c + d for c in (0, up, cycle, 2 * cycle + up,
                                         5 * cycle)
                         for d in (-1, 0, 1) if c + d >= 0}):
        np.testing.assert_allclose(got(count),
                                   float(want(jnp.asarray(count))),
                                   rtol=1e-6, err_msg=f"count {count}")


def test_build_schedule_dispatches_as_the_jax_trainer():
    for name, fn in (("onecyclelr", "onecycle"), ("cycliclr", "cyclic"),
                     ("cycliclrtri2", "cyclic"), ("step", "warmup")):
        sched = toptim.build_schedule(name, 0.1, 4, [2], 1, num_epoch=3,
                                      initial_lr=0.0, final_lr=0.0)
        ref = {"onecycle": joptim.onecycle_schedule(0.1, 4, 3, 1),
               "cyclic": joptim.cyclic_schedule(
                   0.1, 4, "triangular2" if name.endswith("tri2")
                   else "triangular"),
               "warmup": joptim.warmup_step_schedule(0.1, 4, [2], 1)}[fn]
        for count in range(14):
            np.testing.assert_allclose(sched(count),
                                       float(ref(jnp.asarray(count))),
                                       rtol=1e-6, err_msg=f"{name} {count}")
