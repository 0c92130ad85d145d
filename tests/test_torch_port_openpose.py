"""The 15-joint OpenPose path (graph `openpose_b25_j15`, V = 15) of the
port against the JAX package on the CPU.

1. The GCN kernels and the logits kernel at V = 15: the port's wrappers,
   which take their plain versions on CPU tensors, against JAX's Pallas
   kernels in interpret mode (gcn_fused's forward and backward, gcn_kernel's
   `fused_gcn`, `attention_logits_pallas`), at small shapes (tests/
   test_torch_port_ops.py's). Any other joint count V >= 1 passes the
   wrappers' checks (the general kernels take it).
2. The AGCN of configs/openpose_b25_j15_xview/train_joint.yaml (full
   depth: the model has no depth option) and the AAGCN of
   train_joint_aagcn.yaml (cut to 3 blocks), both with `formulation:
   pallas` (AAGCN also `eval_formulation`), built by each package's
   registry from the recipe's model_args; weights are the port's seeded
   init, randomized (BN, PA, a live attention branch), moved to the JAX
   layout and loaded back strict through the port's weight map. Eval
   logits, then one SGD step's raw gradients. The port replays the JAX
   forward's ReLU masks (tools/grad_parity.ReluProbe): a ReLU input within
   fp32 rounding of zero may take the other sign in the other framework and
   move every gradient below it; the two frameworks' ReLU inputs must lie
   within 1e-3 of their layer's mean |input|. With the masks replayed the
   BNs are not shifted away from the kink (tests/test_torch_port_train_
   step.py's shifts of 0.5-0.7 over scales of 0.1-0.2): such inputs put
   each train-mode BN's E[x^2] - E[x]^2 variance over a mean ~4 standard
   deviations away, and the JAX package's fp32 gradients then stood up to
   1.5e-3 of their scale off a float64 step of the port (the port's fp32
   ones 5e-4), so near-centred BN affines keep the reference within its
   own rounding.

Tolerances: the kernels' forward atol 2e-3 and gradients atol 1e-2 (the
bar of tests/test_pallas_gcn.py), bf16 forwards one bf16 rounding apart
(tests/test_torch_port_ops.py's `_BF16_TOL`), the logits kernel 1e-5
(tests/test_torch_port_logits.py); the models' fp32 logits atol 2e-4
(ROADMAP's parity bar), the step's loss 2e-4 and every gradient 1e-3 of
its tensor's scale (`grad_errors`: gradients zero in exact arithmetic 1e-5
of the largest).
"""

import functools
import os
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.models import registry as jax_registry
from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu.ops.pallas import gcn_kernel as jkernel
from agcn_tpu.ops.pallas import logits_kernel as jlk
from agcn_tpu.train import losses as jlosses
from agcn_tpu.utils.torch_import import (aagcn_variables_from_torch,
                                         agcn_variables_from_torch)
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.ops.kernels import gcn_kernel as tkernel
from agcn_tpu_torch.ops.kernels import logits_kernel as tlk
from agcn_tpu_torch.ops.norm import BatchNorm
from agcn_tpu_torch.tools.grad_parity import (ReluProbe, grad_errors,
                                              relu_probe)
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.train.steps import make_train_step
from agcn_tpu_torch.utils.weights import (aagcn_state_dict_from_variables,
                                          agcn_state_dict_from_variables)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 15
_BF16_TOL = 2.0 ** -7
# one jitted JAX program each, compiled at XLA's cheapest level
FAST = {"xla_backend_optimization_level": 0}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_kernels_at_15_joints_match_jax_pallas():
    for t, c, co in ((16, 16, 32), (12, 3, 64)):
        rng = np.random.default_rng(c)
        x = rng.standard_normal((2, t, V, c)).astype(np.float32)
        a1 = rng.standard_normal((2, 3, V, V)).astype(np.float32)
        w = (rng.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(
            np.float32)
        g = rng.standard_normal((2, t, V, co)).astype(np.float32)
        jx, ja1, jw, jg = (jnp.asarray(a) for a in (x, a1, w, g))

        # forward, fp32: both TPU kernels, one function
        with torch.no_grad():
            got_fused = tfused.adaptive_gcn_pallas(_t(x), _t(a1), _t(w))
            got_kernel = tkernel.fused_gcn(_t(x), _t(a1), _t(w))
        np.testing.assert_allclose(
            got_fused.numpy(), _np(jfused.adaptive_gcn_pallas(jx, ja1, jw,
                                                              True)),
            atol=2e-3)
        np.testing.assert_allclose(
            got_kernel.numpy(), _np(jkernel.fused_gcn(jx, ja1, jw, 64,
                                                      True)), atol=2e-3)

        # bf16: each rounding mode against its own TPU kernel
        bx, ba1, bw = (jnp.asarray(a, jnp.bfloat16) for a in (x, a1, w))
        for round_agg, want in (
                (True, jfused.adaptive_gcn_pallas(bx, ba1, bw, True)),
                (False, jkernel.fused_gcn(bx, ba1, bw, 64, True))):
            got = tfused.gcn_fwd_plain(
                *(_t(a, torch.bfloat16) for a in (x, a1, w)), round_agg)
            want = _np(want)
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=_BF16_TOL,
                atol=_BF16_TOL / 8 * np.abs(want).max())

        # backward: the autograd Function (dx on the forward kernel, dW
        # and da1 on gcn_bwd) against jax.vjp of the Pallas pair, and
        # gcn_bwd's plain version against the TPU backward kernel
        _, vjp = jax.vjp(lambda *a: jfused.adaptive_gcn_pallas(*a, True),
                         jx, ja1, jw)
        want_dx, want_da1, want_dw = vjp(jg)
        tx, ta1, tw = (_t(a).requires_grad_() for a in (x, a1, w))
        tfused.adaptive_gcn_pallas(tx, ta1, tw).backward(_t(g))
        for got, want in ((tx.grad, want_dx), (ta1.grad, want_da1),
                          (tw.grad, want_dw)):
            np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-2)
        dw, da1 = tfused.gcn_bwd_plain(_t(x), _t(a1), _t(w), _t(g))
        jdw, jda1 = jfused._backward(jx, ja1, jw, jg, True)
        np.testing.assert_allclose(dw.numpy(), _np(jdw), atol=1e-2)
        np.testing.assert_allclose(da1.numpy(), _np(jda1), atol=1e-2)

    # the logits kernel's entry point on theta/phi views of a fused
    # embedding, V = 15 (the kernel's general tile)
    emb = np.random.default_rng(5).standard_normal(
        (2, 12, V, 2 * 3 * 8)).astype(np.float32)
    e = torch.from_numpy(emb).view(2, 12, V, 2, 3, 8)
    got = tlk.attention_logits_pallas(e[..., 0, :, :], e[..., 1, :, :],
                                      8 * 12)
    je = jnp.asarray(emb).reshape(2, 12, V, 2, 3, 8)
    want = jlk.attention_logits_pallas(je[..., 0, :, :], je[..., 1, :, :],
                                       8 * 12, interpret=True)
    assert got.shape == (2, 3, V, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # on CPU tensors the wrappers took their plain versions
    assert (tfused.adaptive_gcn_pallas.launches, tkernel.fused_gcn.launches,
            tfused.gcn_backward.launches,
            tlk.attention_logits_pallas.launches) == (0, 0, 0, 0)

    # the tuned joint counts are the skeletons'; every other V >= 1 takes
    # the general kernels, and the wrappers' checks pass it (no CUDA call
    # needed to show it); no joints at all raise, naming the tuned set
    assert tfused.TUNED_JOINTS == (15, 18, 25)
    for v in (1, 16, 24, 31, 40, 67):
        tfused._check(torch.zeros(1, 2, v, 4), torch.zeros(1, 3, v, v),
                      torch.zeros(3, 4, 8))
    with pytest.raises(ValueError, match=r"\(15, 18, 25\)"):
        tfused._check(torch.zeros(1, 2, 0, 4), torch.zeros(1, 3, 0, 0),
                      torch.zeros(3, 4, 8))


def _recipe(name, **overrides):
    path = os.path.join(REPO, "configs", "openpose_b25_j15_xview", name)
    with open(path) as f:
        recipe = yaml.safe_load(f)
    return recipe["model"], dict(recipe["model_args"], **overrides)


def _randomize(model, seed):
    """Seeded BN affines (scales 0.5-1.5, shifts about 0) and statistics,
    PA about the graph, and a live attention branch (alpha, conv_ta and
    fc2c start at zero)."""
    rng = np.random.default_rng(seed)

    def draw(p, a):
        p.copy_(torch.from_numpy(np.asarray(a, np.float32)))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                draw(m.weight, rng.uniform(0.5, 1.5, n))
                draw(m.bias, rng.standard_normal(n) * 0.1)
                draw(m.running_mean, rng.standard_normal(n) * 0.1)
                draw(m.running_var, rng.uniform(0.5, 1.5, n))
        for name, p in model.named_parameters():
            if name.endswith(".PA"):
                draw(p, p.numpy() + rng.standard_normal(p.shape) * 0.01)
            elif name.endswith(".alpha"):
                draw(p, rng.uniform(0.5, 1.0, p.shape))
            elif ".conv_ta." in name or ".fc2c." in name:
                draw(p, rng.standard_normal(p.shape) * 0.1)


def _jax_program(fn, *args):
    compiled = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
    return compiled(*args)


def _check_model(name, to_jax, to_port, **overrides):
    kind, args = _recipe(name, **overrides)
    assert (args["num_point"], args["graph"]) == (V, "openpose_b25_j15")
    init = registry.build_model(kind, args, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    _randomize(init, 1)
    variables = jax.tree_util.tree_map(np.asarray,
                                       to_jax(init.state_dict()))
    port = registry.build_model(kind, args, device="cpu")
    port.load_state_dict(to_port(variables), strict=True)
    jmodel = jax_registry.build_model(kind, args)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16, V, 2)).astype(np.float32)
    y = rng.integers(0, args["num_class"], (2,))

    def logits_of(out):  # AAGCN returns (logits, aux)
        return out[0] if isinstance(out, tuple) else out

    # eval logits: the GCN kernel forward (AAGCN's eval_formulation too)
    want = _jax_program(lambda v, xx: logits_of(jmodel.apply(
        v, xx, train=False)), variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == (2, args["num_class"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)

    # one SGD step's raw gradients (train mode, batch statistics)
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
        return jlosses.cross_entropy(logits_of(out), jnp.asarray(y)), relus

    (want_loss, inputs), jgrads = _jax_program(
        jax.value_and_grad(loss_of, has_aux=True), variables["params"])
    want_grads = to_port({"params": jax.tree_util.tree_map(np.asarray,
                                                           jgrads),
                          "batch_stats": variables["batch_stats"]})
    ref = types.SimpleNamespace(
        inputs=[torch.from_numpy(np.asarray(z)) for z in inputs])
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


def test_openpose_agcn_and_aagcn_match_jax():
    _check_model("train_joint.yaml", agcn_variables_from_torch,
                 agcn_state_dict_from_variables, formulation="pallas")
    _check_model("train_joint_aagcn.yaml",
                 functools.partial(aagcn_variables_from_torch, adaptive=True),
                 functools.partial(aagcn_state_dict_from_variables,
                                   adaptive=True),
                 formulation="pallas", eval_formulation="pallas",
                 model_layers=3)
