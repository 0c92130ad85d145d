"""SAM, steps_per_call and the feature-similarity loss of the port against
agcn_tpu's on the CPU: one SAM step (`make_train_step(sam_rho=0.05)`) of a
small AGCN, with and without the PA freeze, and of a small SGN at the
options of `train_sgn_fsim_sam.yaml` (gcn_fpn 0, three levels of temporal
branches) with its fsim loss; SAM's second pass leaves the BN running
statistics to the first; the cosine and fsim losses; SGN's aux outputs
(`branch_outputs`, `z`).

Weights move JAX -> port through the port's state-dict maps with a strict
load (AGCN's conditioned as in tests/test_torch_port_train_step.py, SGN's
w1 random and BN statistics from a train-mode forward as in
tests/test_torch_port_sgn.py).

Tolerances: the fp32 parity bar 2e-4 (absolute) for the loss, the updated
parameters and the BN running statistics; the losses 1e-6 (relative) and
their gradients 1e-6 (absolute); SGN's aux outputs 2e-4; the BN
statistics under SAM bit for bit against the port's own references
(the same CPU computations).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.train import TrainState
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train import make_train_step as jax_train_step
from agcn_tpu.train import optim as joptim
from agcn_tpu.train.trainer import _tree_zero_by_name
from agcn_tpu.utils.torch_import import agcn_variables_from_torch
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.ops.norm import BatchNorm
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.train.steps import freeze_pa, make_train_step
from agcn_tpu_torch.utils.weights import (agcn_state_dict_from_variables,
                                          sgn_state_dict_from_variables)
from tests.test_torch_port_sgn import _jax_variables
from tests.test_torch_port_train_step import (_SCHED, NUM_CLASS, _assert_state,
                                              _batch, _jax_state, _randomize)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
RHO = 0.05
SGN_FSIM = dict(num_class=5, num_point=25, num_segment=20, c_multiplier=0.25,
                sgcn_dims=[16, 32, 32], sgcn_g_proj_dim=32, dropout2d=0.0,
                gcn_fpn=0, multi_t=[[3], [3], [3]], t_mode=1)
SGN_BASE = dict(SGN_FSIM, gcn_fpn=-1, multi_t=[[], [], [3]])
FSIM_ALPHA = [0.1, 0.1]


def _sgd():
    return joptim.sgd_nesterov(joptim.warmup_step_schedule(*_SCHED),
                               weight_decay=1e-4, nesterov=True,
                               grad_clip=1.0)


def _port_sgd(model):
    return toptim.SGDNesterov(model.parameters(),
                              toptim.warmup_step_schedule(*_SCHED),
                              weight_decay=1e-4, nesterov=True, grad_clip=1.0)


# -- SAM on AGCN -----------------------------------------------------------

@pytest.fixture(scope="module")
def agcn():
    adj = jax_build_adjacency("ntu_rgb_d")
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    return adj, _randomize(agcn_variables_from_torch(model.state_dict()))


@functools.lru_cache(maxsize=None)
def _jax_sam_steps():
    """JAX's SAM step and its PA-frozen twin: one program, which takes
    `only_train_part`'s freeze (JAX's `_tree_zero_by_name`) where
    `frozen` is set, run for both."""
    adj = jax_build_adjacency("ntu_rgb_d")
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    variables = _randomize(agcn_variables_from_torch(model.state_dict()))
    _, state = _jax_state(adj, variables, "agg_packed")
    x, y = _batch(1)

    @jax.jit
    def step(state, x, y, frozen):
        def freeze(g):
            return jax.tree_util.tree_map(
                lambda z, a: jnp.where(frozen, z, a),
                _tree_zero_by_name(g, "PA"), g)

        return jax_train_step(jlosses.cross_entropy, sam_rho=RHO,
                              grad_transform=freeze)(
            state, x, y, jax.random.PRNGKey(0))

    out = [step(state, jnp.asarray(x), jnp.asarray(y), frozen)
           for frozen in (False, True)]
    return jax.tree_util.tree_map(np.asarray, out)


def _port_agcn(adj, variables, **kw):
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu", **kw)
    model.load_state_dict(agcn_state_dict_from_variables(variables),
                          strict=True)
    return model, _port_sgd(model)


@pytest.mark.parametrize("frozen", [False, True])
def test_sam_step_matches_jax_on_agcn(agcn, frozen):
    """One SAM step, and with `only_train_part`'s PA freeze applied to
    pass two's gradients: the loss of pass one, then every parameter and
    BN statistic after the update, against JAX's step."""
    adj, variables = agcn
    new_state, jm = _jax_sam_steps()[int(frozen)]
    model, opt = _port_agcn(adj, variables)
    step = make_train_step(model, tlosses.cross_entropy, opt, sam_rho=RHO,
                           grad_transform=freeze_pa if frozen else None)
    x, y = _batch(1)
    m = step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               atol=ATOL, rtol=0)
    assert m["acc"].item() == float(jm["acc"])
    _assert_state(model, new_state.params, new_state.batch_stats)
    assert opt.count == 1
    # the parity is far tighter than what SAM changes: the port's
    # parameters stand 100 times nearer JAX's than plain SGD's do
    plain_model, plain_opt = _port_agcn(adj, variables)
    make_train_step(plain_model, tlosses.cross_entropy, plain_opt)(
        torch.from_numpy(x), torch.from_numpy(y))
    want = agcn_state_dict_from_variables(
        {"params": new_state.params, "batch_stats": new_state.batch_stats})
    plain = dict(plain_model.named_parameters())
    err = max((p - want[n]).abs().max().item()
              for n, p in model.named_parameters())
    sam = max((p - plain[n]).abs().max().item()
              for n, p in model.named_parameters())
    assert 100 * err < sam, (err, sam)


@pytest.mark.parametrize("remat", [False, True])
def test_sam_second_pass_leaves_bn_statistics_to_the_first(agcn, remat):
    """After a SAM step every BN running statistic (and
    `num_batches_tracked`) is that of one train-mode forward at the
    step's starting parameters, bit for bit: pass two moved none of
    them, also where `remat` recomputes each block in the backward."""
    adj, variables = agcn
    x, y = _batch(3)
    model, opt = _port_agcn(adj, variables, remat=remat)
    first_pass = copy.deepcopy(model).train()
    with torch.no_grad():
        first_pass(torch.from_numpy(x))
    make_train_step(model, tlosses.cross_entropy, opt, sam_rho=RHO)(
        torch.from_numpy(x), torch.from_numpy(y))
    want = dict(first_pass.named_buffers())
    norms = 0
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            norms += 1
            assert int(mod.num_batches_tracked) == 1, name
            for buf in ("running_mean", "running_var"):
                assert torch.equal(getattr(mod, buf),
                                   want[f"{name}.{buf}"]), (name, buf)
            assert not mod.recomputing, name
    # data_bn, each block's GCN and TCN BN, the GCN down paths of the
    # blocks whose width changes (1, 5, 8) and the residuals of 5 and 8
    assert norms == 26


# -- SAM with the fsim loss on SGN -----------------------------------------

def _jax_fsim(aux, y):
    return jlosses.fsim_pair_loss(aux["branch_outputs"], FSIM_ALPHA, 1,
                                  mode=1), {}


def _port_fsim(aux, y):
    total = tlosses.fsim_pair_loss(aux["branch_outputs"], FSIM_ALPHA, 1,
                                   mode=1)
    return total, {"fsim": total}


def test_sam_step_with_the_fsim_loss_matches_jax_on_sgn():
    """One SAM step of a small SGN at the fsim_sam recipe's options, its
    loss the label-smoothed CE plus the fsim pairs of the three levels'
    branches: the loss, every parameter and BN statistic after it."""
    model, variables = _jax_variables(SGN_FSIM, 20, 25)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 20, 75)).astype(np.float32)
    y = np.array([0, 3, 1, 4])
    loss = jlosses.build_loss("ce", 5, smoothing=0.1)
    state = TrainState.create(model.apply, variables["params"],
                              variables["batch_stats"], _sgd())
    step = jax.jit(jax_train_step(loss, sam_rho=RHO, aux_loss_fn=_jax_fsim))
    new_state, jm = step(state, jnp.asarray(x), jnp.asarray(y),
                         jax.random.PRNGKey(0))
    port = registry.build_model("sgn", SGN_FSIM, device="cpu", num_frame=20)
    port.load_state_dict(sgn_state_dict_from_variables(variables),
                         strict=True)
    opt = _port_sgd(port)
    m = make_train_step(port, tlosses.build_loss("ce", 5, smoothing=0.1),
                        opt, sam_rho=RHO, aux_loss_fn=_port_fsim)(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               atol=ATOL, rtol=0)
    assert 0 < m["fsim"].item() < m["loss"].item()
    want = sgn_state_dict_from_variables(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params,
                     "batch_stats": new_state.batch_stats}))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       atol=ATOL, rtol=0, err_msg=name)


# -- the losses and SGN's aux outputs --------------------------------------

@pytest.mark.parametrize("mode", [1, 2])
def test_cosine_loss_matches_jax(mode):
    rng = np.random.default_rng(mode)
    a, b = (rng.standard_normal((4, 8, 6)).astype(np.float32)
            for _ in range(2))
    b[0] = 0.0  # a zero feature: the eps clamp
    want, wgrad = jax.value_and_grad(
        lambda u: jlosses.cosine_loss(u, jnp.asarray(b), mode=mode))(
        jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    got = tlosses.cosine_loss(at, torch.from_numpy(b), mode=mode)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(wgrad),
                               atol=1e-6)


@pytest.mark.parametrize("n,kernels,alphas,mode", [
    (3, 1, [0.1, 0.1], 1), (4, 2, [0.3], 2), (6, 2, [0.5, 0.25, 1.0], 1),
    (1, 1, [0.1], 1)])
def test_fsim_pair_loss_matches_jax(n, kernels, alphas, mode):
    """The reference's pairing: level i's kernel j toward the last level's
    kernel j, alpha by flat pair index (the last alpha past the list); one
    level alone pairs nothing."""
    rng = np.random.default_rng(n)
    outs = [rng.standard_normal((3, 8, 5)).astype(np.float32)
            for _ in range(n)]
    outs.insert(1, None)  # dropped
    want = jlosses.fsim_pair_loss(
        [None if o is None else jnp.asarray(o) for o in outs], alphas,
        kernels, mode=mode)
    got = tlosses.fsim_pair_loss(
        [None if o is None else torch.from_numpy(o) for o in outs], alphas,
        kernels, mode=mode)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("args", [SGN_BASE, SGN_FSIM],
                         ids=["gcn_fpn-1", "gcn_fpn0"])
def test_sgn_aux_outputs_match_jax(args):
    """`forward(x, return_aux=True)`: the logits, each temporal branch's
    output in (N, C, T) layout, `z` and G against the JAX model's aux; the
    served forward is unchanged by the option."""
    model, variables = _jax_variables(args, 20, 25)
    x = np.random.default_rng(7).standard_normal((4, 20, 75)).astype(
        np.float32)
    logits, aux = jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.asarray(x))
    port = registry.build_model("sgn", args, device="cpu", num_frame=20)
    port.load_state_dict(sgn_state_dict_from_variables(variables),
                         strict=True)
    port.eval()
    with torch.no_grad():
        got, got_aux = port(torch.from_numpy(x), return_aux=True)
        served = port(torch.from_numpy(x))
    assert torch.equal(got, served)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL)
    levels = len(args["multi_t"]) if args["gcn_fpn"] == 0 else 1
    assert len(got_aux["branch_outputs"]) == len(aux["branch_outputs"]) \
        == levels
    for g, w in zip(got_aux["branch_outputs"], aux["branch_outputs"]):
        assert g.shape == w.shape == (4, 128, 20)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert got_aux["z"].shape == (4, 128)
    np.testing.assert_allclose(got_aux["z"].numpy(), np.asarray(aux["z"]),
                               atol=ATOL)
    assert len(got_aux["g"]) == len(aux["g"]) == 1
    np.testing.assert_allclose(got_aux["g"][0].numpy(),
                               np.asarray(aux["g"][0][0]), atol=ATOL)
