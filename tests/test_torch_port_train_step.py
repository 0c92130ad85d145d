"""The port's AGCN train step against agcn_tpu's `make_train_step` on the
CPU: the same weights (moved by `agcn_state_dict_from_variables`), the
same seeded batches, the SGD chain of the recipes (clip 1.0, weight decay
1e-4, nesterov momentum, warmup-step LR). The JAX 'pallas' forms run
their Pallas kernels in interpret mode and route the C=3 entry layer to
'agg_packed'; the port runs its kernels' plain versions at every layer
(the same function).

Tolerance: atol 2e-4, the fp32 parity bar (tests/test_agcn.py), for the
loss, every gradient, the updated parameters and the BN running
statistics; 1e-4 relative for a 20-step loss trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.models.agcn import AGCN as JaxAGCN
from agcn_tpu.train import TrainState, make_train_step
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train import optim as joptim
from agcn_tpu.utils.torch_import import agcn_variables_from_torch
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.train.steps import make_train_step as port_train_step
from agcn_tpu_torch.utils.weights import agcn_state_dict_from_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS, T, BATCH = 7, 16, 2
ATOL = 2e-4
_SCHED = (0.1, 4, [2], 1)  # base lr, steps/epoch, decay epochs, warmup


def _randomize(variables, seed=0):
    """Seeded BN affines/statistics and PA, so every layer — the GCN too,
    whose BN starts at scale 1e-6 — carries gradient.

    BN shifts of 0.5-0.7 over scales of 0.1-0.2 keep every ReLU input
    some 4 standard deviations above zero. Near zero, the fp32 rounding of
    two frameworks may put a pre-activation on different sides of the
    kink, and one such flip moves the gradients of every layer below it
    far beyond the bar: with unit scales and zero shifts nearly every
    seeded batch held a flip somewhere in the ten blocks."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        is_bn = "scale" in node
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif k == "PA":
                out[k] = (rng.standard_normal(v.shape) * 0.01).astype(
                    np.float32)
            elif stats and k == "mean":
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    np.float32)
            elif stats and k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.1, 0.2, v.shape).astype(np.float32)
            elif is_bn and k == "bias":
                out[k] = rng.uniform(0.5, 0.7, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, 3, T, 25, 2)).astype(np.float32)
    y = rng.integers(0, NUM_CLASS, (BATCH,))
    return x, y


@pytest.fixture(scope="module")
def setup():
    adj = jax_build_adjacency("ntu_rgb_d")
    # the port's seeded init in the JAX layout (no JAX init to compile)
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    variables = agcn_variables_from_torch(model.state_dict())
    return adj, _randomize(variables)


def _jax_state(adj, variables, form):
    model = JaxAGCN(num_class=NUM_CLASS, adj=adj, formulation=form)
    tx = joptim.sgd_nesterov(joptim.warmup_step_schedule(*_SCHED),
                             weight_decay=1e-4, nesterov=True, grad_clip=1.0)
    return model, TrainState.create(model.apply, variables["params"],
                                    variables["batch_stats"], tx)


def _port(adj, variables, form):
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
                 formulation=form)
    model.load_state_dict(agcn_state_dict_from_variables(variables),
                          strict=True)
    opt = toptim.SGDNesterov(model.parameters(),
                             toptim.warmup_step_schedule(*_SCHED),
                             weight_decay=1e-4, nesterov=True, grad_clip=1.0)
    return model, opt, port_train_step(model, tlosses.cross_entropy, opt)


def _assert_state(model, params, batch_stats):
    want = agcn_state_dict_from_variables({"params": params,
                                           "batch_stats": batch_stats})
    got = model.state_dict()
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)


def check_one_step(adj, variables, form):
    """One train step of `form` against the JAX step: loss, accuracy, the
    raw gradients, the updated parameters and BN running statistics."""
    x, y = _batch(1)
    jmodel, state = _jax_state(adj, variables, form)

    def loss_of(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy(logits, jnp.asarray(y))

    jax_step = make_train_step(jlosses.cross_entropy)

    @jax.jit
    def grads_and_step(state):
        # one program: the raw gradients beside the step that clips them
        return jax.grad(loss_of)(state.params), jax_step(
            state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))

    jgrads, (new_state, jm) = grads_and_step(state)

    model, opt, _ = _port(adj, variables, form)
    raw = {}

    def keep_raw_grads(model):  # runs before the optimizer clips in place
        raw.update((n, p.grad.clone()) for n, p in model.named_parameters())

    step = port_train_step(model, tlosses.cross_entropy, opt,
                           grad_transform=keep_raw_grads)
    m = step(torch.from_numpy(x), torch.from_numpy(y))
    want_grads = agcn_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]})
    for name, g in raw.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               atol=ATOL, rtol=0)
    assert m["acc"].item() == float(jm["acc"])
    _assert_state(model, jax.tree_util.tree_map(np.asarray, new_state.params),
                  jax.tree_util.tree_map(np.asarray, new_state.batch_stats))
    assert opt.count == 1
    assert int(model.data_bn.num_batches_tracked) == 1


def test_one_train_step_matches_jax(setup):
    """'agg_packed'; tests/test_torch_port_train_step_pallas.py runs the
    two pallas forms."""
    check_one_step(*setup, "agg_packed")


def test_twenty_steps_track_jax(setup):
    adj, variables = setup
    _, state = _jax_state(adj, variables, "agg_packed")
    jstep = jax.jit(make_train_step(jlosses.cross_entropy))
    model, opt, step = _port(adj, variables, "agg_packed")
    want, got = [], []
    for i in range(20):
        x, y = _batch(10 + i)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0))
        want.append(float(jm["loss"]))
        got.append(step(torch.from_numpy(x),
                        torch.from_numpy(y))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert opt.count == 20


def test_remat_gives_the_same_step_and_updates_stats_once(setup):
    adj, variables = setup
    x, y = _batch(2)
    out = {}
    for remat in (False, True):
        model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
                     formulation="pallas", remat=remat)
        model.load_state_dict(agcn_state_dict_from_variables(variables))
        model.train()
        loss = tlosses.cross_entropy(model(torch.from_numpy(x)),
                                     torch.from_numpy(y))
        loss.backward()
        out[remat] = (loss.item(), model)
    ref, rem = out[False][1], out[True][1]
    assert out[True][0] == pytest.approx(out[False][0], abs=1e-6)
    for (name, p), q in zip(ref.named_parameters(), rem.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                   atol=1e-6, err_msg=name)
    for name, buf in ref.named_buffers():
        torch.testing.assert_close(rem.get_buffer(name), buf, rtol=0,
                                   atol=1e-6, msg=name)
    assert int(rem.l3.tcn1.bn.num_batches_tracked) == 1
