"""The GCN kernels at a joint count outside the tuned 15, 18 and 25 (the
general kernels of `csrc/gcn_fwd.cu` and `csrc/gcn_bwd.cu`) against the
JAX package on the CPU.

1. The kernels at V = 7, 31 and 40: the port's wrappers, which take their
   plain versions on CPU tensors, against JAX's Pallas kernels in
   interpret mode (gcn_fused's forward and its gradients of x, a1 and W,
   gcn_kernel's `fused_gcn`, and at V = 7 and 31 `attention_logits_pallas`)
   at B = 2, T = 9, fp32 and bf16. `_check` takes any V >= 1; at V = 40
   the logits kernel's wrapper raises ValueError on the CPU as JAX's
   kernel does (V <= 32).
2. AGCN at full width (10 blocks, 60 classes) on the 31-node STGAT
   expanded graph of NTU-25, `adj = [I, N, N^T]` with N the in-degree
   normalized graph without its self links, built by each package's own
   graph module: the port with `formulation: pallas` (the kernels' plain
   versions here), the JAX model with `formulation: agg`, its plain
   reference (its Pallas AGCN runs for tens of seconds in interpret mode
   at this size). The port's seeded weights, randomized, move to the JAX
   layout and back strictly through the weight maps. Eval logits, then
   one SGD step's loss and raw gradients with the JAX forward's ReLU
   masks replayed (tests/test_torch_port_openpose.py's `_check_model`).

Tolerances: the kernels' forward atol 2e-3 and gradients atol 1e-2 (the
bar of tests/test_pallas_gcn.py), bf16 forwards one bf16 rounding apart
(tests/test_torch_port_ops.py's `_BF16_TOL`), the logits kernel 1e-5
(tests/test_torch_port_logits.py); the model's fp32 logits atol 2e-4
(ROADMAP's parity bar), the step's loss 2e-4 and every gradient 1e-3 of
its tensor's scale (`grad_errors`).
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build as jgraph
from agcn_tpu.graph.skeletons import get_skeleton as jget_skeleton
from agcn_tpu.models.agcn import AGCN as JaxAGCN
from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu.ops.pallas import gcn_kernel as jkernel
from agcn_tpu.ops.pallas import logits_kernel as jlk
from agcn_tpu.train import losses as jlosses
from agcn_tpu.utils.torch_import import agcn_variables_from_torch
from agcn_tpu_torch.graph import build as tgraph
from agcn_tpu_torch.graph.skeletons import get_skeleton
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.ops.kernels import gcn_kernel as tkernel
from agcn_tpu_torch.ops.kernels import logits_kernel as tlk
from agcn_tpu_torch.tools.grad_parity import (ReluProbe, grad_errors,
                                              relu_probe)
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.train.steps import make_train_step
from agcn_tpu_torch.utils.weights import agcn_state_dict_from_variables
from tests.test_torch_port_openpose import _jax_program, _randomize
from tests.torch_port_threads import one_torch_thread  # noqa: F401

_BF16_TOL = 2.0 ** -7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _stgat_adj(graph, skeleton):
    """[I, N, N^T] over the STGAT expanded graph (31 nodes), N the
    in-degree normalized graph without its self links."""
    a = graph.expanded_graph(skeleton("ntu_rgb_d"), 1)
    eye = np.eye(a.shape[0])
    n = graph.normalize_in_degree(a - eye)
    return np.stack([eye, n, n.T]).astype(np.float32)


# (V, C, Co): below the 32-joint tile with C = 16, the STGAT graph with the
# C = 3 entry layer, and two joint tiles with C, Co off the chunks
CASES = [(7, 16, 8), (31, 3, 16), (40, 12, 10)]


def _inputs(v, c, co):
    """x, a1, W, the output gradient g and a fused theta/phi embedding."""
    rng = np.random.default_rng(v)
    x = rng.standard_normal((2, 9, v, c)).astype(np.float32)
    a1 = rng.standard_normal((2, 3, v, v)).astype(np.float32)
    w = (rng.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(np.float32)
    g = rng.standard_normal((2, 9, v, co)).astype(np.float32)
    emb = rng.standard_normal((2, 9, v, 2 * 3 * 8)).astype(np.float32)
    return x, a1, w, g, emb


def _jax_side(jx, ja1, jw, jg, jemb):
    """Every JAX kernel call of one case: the Pallas forward's value and
    vjp, `fused_gcn` in fp32, both rounding modes in bf16, and at V <= 32
    the logits kernel."""
    v = jx.shape[2]
    y, vjp = jax.vjp(lambda *a: jfused.adaptive_gcn_pallas(*a, True),
                     jx, ja1, jw)
    b16 = [a.astype(jnp.bfloat16) for a in (jx, ja1, jw)]
    out = dict(y=y, grads=vjp(jg),
               fused=jkernel.fused_gcn(jx, ja1, jw, 64, True),
               bf16={True: jfused.adaptive_gcn_pallas(*b16, True),
                     False: jkernel.fused_gcn(*b16, 64, True)})
    if v <= 32:
        je = jemb.reshape(2, 9, v, 2, 3, 8)
        out["logits"] = jlk.attention_logits_pallas(
            je[..., 0, :, :], je[..., 1, :, :], 8 * 9, interpret=True)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side of every case, one compiled program for all of them."""
    args = [tuple(jnp.asarray(a) for a in _inputs(*case)) for case in CASES]
    want = _jax_program(lambda cases: [_jax_side(*a) for a in cases], args)
    return {case[0]: w for case, w in zip(CASES, want)}


@pytest.mark.parametrize("v,c,co", CASES)
def test_general_v_kernels_match_jax_pallas(v, c, co, jax_refs):
    x, a1, w, g, emb = _inputs(v, c, co)
    # the wrappers' checks take this V (no CUDA call needed to show it)
    tfused._check(_t(x), _t(a1), _t(w))
    want = jax_refs[v]

    # forward, fp32: both TPU kernels, one function
    with torch.no_grad():
        got_kernel = tkernel.fused_gcn(_t(x), _t(a1), _t(w))
    np.testing.assert_allclose(got_kernel.numpy(), _np(want["fused"]),
                               atol=2e-3)

    # bf16: each rounding mode against its own TPU kernel
    for round_agg in (True, False):
        got = tfused.gcn_fwd_plain(
            *(_t(a, torch.bfloat16) for a in (x, a1, w)), round_agg)
        ref = _np(want["bf16"][round_agg])
        np.testing.assert_allclose(
            got.float().numpy(), ref, rtol=_BF16_TOL,
            atol=_BF16_TOL / 8 * np.abs(ref).max())

    # the autograd Function (dx on the forward kernel, dW and da1 on
    # gcn_bwd) against jax.vjp of the Pallas pair (its _bwd_kernel)
    tx, ta1, tw = (_t(a).requires_grad_() for a in (x, a1, w))
    y = tfused.adaptive_gcn_pallas(tx, ta1, tw)
    np.testing.assert_allclose(y.detach().numpy(), _np(want["y"]),
                               atol=2e-3)
    y.backward(_t(g))
    for got, ref in zip((tx.grad, ta1.grad, tw.grad), want["grads"]):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-2)

    # the logits kernel's entry point on theta/phi views of a fused
    # embedding: its general tile up to 32 joints; past it both raise
    e = torch.from_numpy(emb).view(2, 9, v, 2, 3, 8)
    if v <= 32:
        got = tlk.attention_logits_pallas(e[..., 0, :, :], e[..., 1, :, :],
                                          8 * 9)
        assert got.shape == (2, 3, v, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want["logits"]),
                                   atol=1e-5, rtol=1e-5)
    else:
        je = jnp.asarray(emb).reshape(2, 9, v, 2, 3, 8)
        with pytest.raises(ValueError):
            jlk.attention_logits_pallas(je[..., 0, :, :], je[..., 1, :, :],
                                        8 * 9, interpret=True)
        with pytest.raises(ValueError, match="at most 32"):
            tlk.attention_logits_pallas(e[..., 0, :, :], e[..., 1, :, :],
                                        8 * 9)
    # on CPU tensors the wrappers took their plain versions
    assert (tfused.adaptive_gcn_pallas.launches, tkernel.fused_gcn.launches,
            tfused.gcn_backward.launches,
            tlk.attention_logits_pallas.launches) == (0, 0, 0, 0)


def test_agcn_on_the_stgat_graph_matches_jax():
    adj = _stgat_adj(tgraph, get_skeleton)
    np.testing.assert_array_equal(adj, _stgat_adj(jgraph, jget_skeleton))
    assert adj.shape == (3, 31, 31)
    init = AGCN(num_class=60, num_point=31, adj=adj, formulation="pallas",
                device="cpu", generator=torch.Generator().manual_seed(0))
    _randomize(init, 1)
    variables = jax.tree_util.tree_map(
        np.asarray, agcn_variables_from_torch(init.state_dict()))
    port = AGCN(num_class=60, num_point=31, adj=adj, formulation="pallas",
                device="cpu")
    port.load_state_dict(agcn_state_dict_from_variables(variables),
                         strict=True)
    jmodel = JaxAGCN(num_class=60, num_point=31, adj=adj, formulation="agg")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 8, 31, 2)).astype(np.float32)
    y = rng.integers(0, 60, (2,))

    def loss_of(params):
        # flax's nn.relu, recording each call's input in call order
        relus = []
        plain = flax.linen.relu
        flax.linen.relu = lambda z: relus.append(z) or jax.nn.relu(z)
        try:
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
        finally:
            flax.linen.relu = plain
        return jlosses.cross_entropy(out, jnp.asarray(y)), relus

    # eval logits and one step's loss, ReLU inputs and gradients: one
    # JAX program
    want, ((want_loss, inputs), jgrads) = _jax_program(
        lambda v, xx: (jmodel.apply(v, xx, train=False),
                       jax.value_and_grad(loss_of, has_aux=True)(
                           v["params"])),
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == (2, 60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)

    want_grads = agcn_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]})
    ref = types.SimpleNamespace(
        inputs=[torch.from_numpy(np.array(z)) for z in inputs])
    ref.masks = [z > 0 for z in ref.inputs]
    probe = ReluProbe(ref=ref)
    raw = {}
    opt = toptim.SGDNesterov(port.parameters(),
                             toptim.warmup_step_schedule(0.1, 4, [2], 1),
                             weight_decay=1e-4, nesterov=True, grad_clip=1.0)
    step = make_train_step(port.train(), tlosses.cross_entropy, opt,
                           grad_transform=lambda m: raw.update(
                               (n, p.grad.clone())
                               for n, p in m.named_parameters()))
    with relu_probe(probe):
        m = step(torch.from_numpy(x), torch.from_numpy(y))
    assert len(probe.masks) == len(ref.masks) > 0
    assert probe.input_diff <= 1e-3, probe.input_diff
    np.testing.assert_allclose(m["loss"].item(), float(want_loss),
                               atol=2e-4)
    errs = grad_errors(raw, {n: want_grads[n] for n in raw}, 1e-3)
    assert errs[0][0] <= 1.0, errs[:3]
    assert opt.count == 1
    # on CPU tensors the model ran the kernels' plain versions
    assert (tfused.adaptive_gcn_pallas.launches,
            tfused.gcn_backward.launches) == (0, 0)
