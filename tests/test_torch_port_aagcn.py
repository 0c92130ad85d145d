"""The port's AAGCN (agcn_tpu_torch/models/aagcn.py) and the ops it
brings (the fused static operator, Ghost BatchNorm, LayerNorm) against
the JAX package on the CPU, at small sizes (T <= 16, batch 2).

Weights move JAX -> port through the port's
`aagcn_state_dict_from_variables` with a strict load. The attention
branch starts at zero in both (alpha, conv_ta, fc2c), so the weights are
randomized first, or it would never be exercised. The JAX 'pallas' forms
run their Pallas kernels in interpret mode; the port runs the kernels'
plain versions.

Tolerances: fp32 logits, BN statistics and one train step's gradients
atol 2e-4 (tests/test_aagcn.py's bar); ops atol 1e-5 (the fused
operator, whose entries reach ~40, also rtol 1e-5; 1e-4 for the norms'
running statistics); bf16 logits 2% of the
logit scale (another summation order, ~3 significant digits per layer);
the served probabilities 1e-4; a two-epoch trainer run 1e-3 relative,
top-1 equal.
"""

import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agcn_tpu import ops as jops
from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.infer.serving import BatchedStreamServer as JaxServer
from agcn_tpu.models.aagcn import AAGCN as JaxAAGCN
from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.train import TrainState, make_train_step
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train import optim as joptim
from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu.train.trainer import Trainer as JaxTrainer
from agcn_tpu.utils.config import Config as JaxConfig
from agcn_tpu.utils.torch_import import aagcn_variables_from_torch
from agcn_tpu_torch import ops as tops
from agcn_tpu_torch.infer import BatchedStreamServer
from agcn_tpu_torch.main import main as port_main
from agcn_tpu_torch.models.aagcn import AAGCN, layer_plan
from agcn_tpu_torch.models.registry import build_model
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops.kernels import gcn_fused
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.train.steps import make_train_step as port_train_step
from agcn_tpu_torch.utils.weights import (aagcn_state_dict_from_variables,
                                          load_checkpoint, model_state_dict)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7
ADJ = jax_build_adjacency("ntu_rgb_d")


def _x(seed=3, n=2, t=16):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, t, 25, 2)).astype(np.float32)


def _randomize(variables, seed=0, condition=False):
    """Seeded BN statistics and affines, PA about the graph, and a live
    attention branch (alpha, conv_ta, fc2c away from their zero init).
    `condition`: BN shifts 0.5-0.7 over scales 0.1-0.2, which keep ReLU
    inputs away from the kink for gradient parity
    (tests/test_torch_port_train_step.py)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    def walk(node, stats, path):
        is_bn = "scale" in node and "kernel" not in node
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats, path + (k,))
            elif k == "PA":
                out[k] = f32(v + rng.standard_normal(v.shape) * 0.05)
            elif k == "alpha":
                out[k] = f32(rng.uniform(0.5, 1.0, v.shape))
            elif "conv_ta" in path or "fc2c" in path:
                out[k] = f32(rng.standard_normal(v.shape) * 0.1)
            elif stats and k == "mean":
                out[k] = f32(rng.standard_normal(v.shape) * 0.1)
            elif stats and k == "var":
                out[k] = f32(rng.uniform(0.5, 1.5, v.shape))
            elif is_bn and k == "scale":
                out[k] = f32(rng.uniform(0.1, 0.2, v.shape) if condition
                             else rng.uniform(0.5, 1.5, v.shape))
            elif is_bn and k == "bias":
                out[k] = f32(rng.uniform(0.5, 0.7, v.shape) if condition
                             else v + rng.standard_normal(v.shape) * 0.1)
            else:
                out[k] = f32(v)
        return out

    return {"params": walk(variables["params"], False, ()),
            "batch_stats": walk(variables["batch_stats"], True, ())}


def _to_jax(model, **kw):
    return aagcn_variables_from_torch(
        model.state_dict(), adaptive=kw.get("adaptive", True),
        data_norm=kw.get("data_norm", "bn"))


def _variables(seed=0, condition=False, **kw):
    """The port's seeded init in the JAX layout, randomized. Without
    `condition` (weights for eval), every BN's running statistics are
    then set to its batch statistics in a train-mode forward on other
    data: eval then normalizes as training would, where random statistics
    let the attention's x * (1 + se) grow the logits 1e5-fold over ten
    blocks."""
    model = AAGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
                  generator=torch.Generator().manual_seed(seed), **kw)
    variables = _randomize(_to_jax(model, **kw), seed, condition)
    if condition:
        return variables
    model = _port(variables, **kw).train()
    norms = [m for m in model.modules() if isinstance(m, tops.BatchNorm)]
    for m in norms:
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
    with torch.no_grad():
        model(torch.from_numpy(_x(seed=seed + 11)))
    for m in norms:  # undo the momentum-0.1 update from (0, 1)
        m.running_mean.div_(0.1)
        m.running_var.sub_(0.9).div_(0.1).clamp_(min=1e-3)
    return _to_jax(model, **kw)


def _port(variables, **kw):
    model = AAGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu", **kw)
    model.load_state_dict(aagcn_state_dict_from_variables(
        variables, adaptive=kw.get("adaptive", True)), strict=True)
    return model


def _jax_logits(variables, x, train=False, **kw):
    model = JaxAAGCN(num_class=NUM_CLASS, adj=ADJ, **kw)
    if train:
        (logits, _), mutated = model.apply(variables, jnp.asarray(x),
                                           train=True,
                                           mutable=["batch_stats"])
        return np.asarray(logits), mutated["batch_stats"]
    return np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False)[0]), None


# -- ops ---------------------------------------------------------------


def test_fused_static_operator_matches_jax():
    rng = np.random.default_rng(0)
    adj = rng.standard_normal((3, 25, 25)).astype(np.float32)
    w = rng.standard_normal((3, 6, 10)).astype(np.float32)
    x = rng.standard_normal((2, 4, 25, 6)).astype(np.float32)
    want_op = jgcn.fused_static_operator(jnp.asarray(adj), jnp.asarray(w))
    got_op = tgcn.fused_static_operator(torch.from_numpy(adj),
                                        torch.from_numpy(w))
    assert got_op.shape == (25 * 6, 25 * 10)
    np.testing.assert_allclose(got_op.numpy(), np.asarray(want_op),
                               atol=1e-5, rtol=1e-5)
    want = jgcn.apply_fused_static(jnp.asarray(x), want_op, 25)
    got = tgcn.apply_fused_static(torch.from_numpy(x), got_op, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("splits", [0, 1, 2, 4])
def test_ghost_batchnorm_matches_jax(splits):
    """Train-mode output and running statistics; 0 and 1 are plain BN,
    as in the JAX package (train_joint_aagcn_local.yaml has gbn_split 0)."""
    rng = np.random.default_rng(splits)
    x = (rng.standard_normal((8, 6, 5, 3)) * 2 + 1).astype(np.float32)
    jbn = jops.BatchNorm(splits=splits)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    want, mutated = jbn.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    bn = tops.BatchNorm(3, splits=splits).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-4)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-4)
    # eval: the running statistics, one affine
    want_eval = jbn.apply({"params": variables["params"],
                           "batch_stats": stats}, jnp.asarray(x),
                          train=False)
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).numpy(),
                                   np.asarray(want_eval), atol=1e-5)


def test_layernorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 7, 6)).astype(
        np.float32) * 3
    jln = jops.LayerNorm()
    variables = jln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = np.random.default_rng(1).uniform(0.5, 1.5, 6).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.full(6, 0.3)}}
    want = jln.apply(variables, jnp.asarray(x))
    ln = tops.LayerNorm(6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.fill_(0.3)
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- the model -----------------------------------------------------------


@pytest.mark.parametrize("model_layers", [3, 10])
@pytest.mark.parametrize("adaptive,attention", [(True, True), (True, False),
                                                (False, True),
                                                (False, False)])
def test_aagcn_matches_jax(adaptive, attention, model_layers):
    """Eval logits, then a train-mode forward: logits and every BN's
    batch-updated running statistics."""
    kw = dict(adaptive=adaptive, attention=attention,
              model_layers=model_layers)
    variables = _variables(**kw)
    x = _x()
    model = _port(variables, **kw)
    want, _ = _jax_logits(variables, x, **kw)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, NUM_CLASS)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)

    want, stats = _jax_logits(variables, x, train=True, **kw)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    after = aagcn_state_dict_from_variables(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)},
        adaptive=adaptive)
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                       atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(model_layers=3, fc_cv=True),
    dict(model_layers=3, data_norm="ln"),
    dict(model_layers=3, gbn_split=2),
    dict(model_layers=3, attn_form="blockdiag"),
    dict(model_layers=102, backbone_dim=32),
    dict(model_layers=1002, kernel_size=3, stride=2),
    dict(model_layers=101, backbone_dim=16, kernel_size=3, pad=False),
    dict(model_layers=1003, backbone_dim=16, kernel_size=3, stride=2)],
    ids=["fc_cv", "ln", "gbn_split2", "blockdiag", "plan102", "plan1002",
         "plan101_unpadded", "plan1003"])
def test_aagcn_options_match_jax(kw):
    variables = _variables(**kw)
    x = _x()
    model = _port(variables, **kw)
    for train in (False, True):
        want, _ = _jax_logits(variables, x, train=train, **kw)
        with torch.no_grad():
            got = model.train(train)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0,
                                   err_msg=f"train={train}")


def test_layer_plans_match_jax():
    from agcn_tpu.models.aagcn import layer_plan as jax_layer_plan

    for layers in (0, 3, 6, 7, 10, 101, 102, 103, 1002, 1003):
        assert layer_plan(layers, 48) == jax_layer_plan(layers, 48)
    with pytest.raises(ValueError, match="not supported"):
        layer_plan(5)


def test_aagcn_bf16_close_to_jax_bf16():
    """bf16 compute on the kernel form at eval (eval_formulation pallas):
    the STC attention promotes to fp32 in both, as the dtype-less flax
    layers do."""
    kw = dict(formulation="pallas", eval_formulation="pallas")
    variables = _variables()
    x = _x()
    want = np.asarray(JaxAAGCN(num_class=NUM_CLASS, adj=ADJ,
                               dtype=jnp.bfloat16, **kw).apply(
        variables, jnp.asarray(x), train=False)[0], np.float32)
    with torch.no_grad():
        got = _port(variables, dtype=torch.bfloat16, **kw).eval()(
            torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_state_dict_is_the_reference_map():
    """Strict load through the port's map: the same names as the
    reference, conv_d under the unit and under agcn as one tensor."""
    variables = _variables()
    model = _port(variables)
    sd = model.state_dict()
    assert set(sd) == set(aagcn_state_dict_from_variables(variables))
    gcn = model.l1.gcn1
    assert gcn.conv_d[0].weight is gcn.agcn.conv_d[0].weight
    for key, shape in [("l1.gcn1.agcn.PA", (3, 25, 25)),
                       ("l1.gcn1.agcn.alpha", (1,)),
                       ("l1.gcn1.agcn.conv_a.0.weight", (16, 3, 1, 1)),
                       ("l1.gcn1.conv_d.2.weight", (64, 3, 1, 1)),
                       ("l1.gcn1.agcn.conv_d.2.weight", (64, 3, 1, 1)),
                       ("l1.gcn1.attn_s.conv_sa.weight", (1, 64, 25)),
                       ("l1.gcn1.attn_t.conv_ta.weight", (1, 64, 9)),
                       ("l5.gcn1.attn_c.fc1c.weight", (64, 128)),
                       ("l5.gcn1.attn_c.fc2c.weight", (128, 64)),
                       ("l5.residual.conv.weight", (128, 64, 1, 1)),
                       ("data_bn.running_mean", (150,)),
                       ("fc.weight", (NUM_CLASS, 256))]:
        assert tuple(sd[key].shape) == shape, key
    # non-adaptive: conv_d under the unit only, no PA
    plain = _port(_variables(adaptive=False), adaptive=False)
    names = set(plain.state_dict())
    assert "l1.gcn1.conv_d.0.weight" in names
    assert not any(".agcn." in n for n in names)
    # the registry, the reference aliases, and checkpoint dispatch
    for name in ("aagcn", "model.aagcn.Model",
                 "model.architecture.aagcn.aagcn.Model"):
        built = build_model(name, {"num_class": NUM_CLASS,
                                   "model_layers": 3}, device="cpu")
        assert isinstance(built, AAGCN)
    for name in ("aagcn_transformer", "aagcn_v31", "model.aagcn_v17.Model",
                 "sgn"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            build_model(name, {}, device="cpu")
    got = model_state_dict(variables, "aagcn")
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_checkpoint_files_load_strict(tmp_path):
    variables = _variables(model_layers=3)
    save_checkpoint(str(tmp_path / "ckpt"), variables, use_orbax=False)
    base = _port(variables, model_layers=3).eval()
    torch.save(base.state_dict(), tmp_path / "w.pt")
    x = torch.from_numpy(_x())
    for path in (tmp_path / "ckpt", tmp_path / "w.pt"):
        model = AAGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
                      model_layers=3)
        model.load_state_dict(model_state_dict(
            load_checkpoint(str(path)), "aagcn"), strict=True)
        with torch.no_grad():
            torch.testing.assert_close(model.eval()(x), base(x))


def test_eval_runs_the_kernel_only_with_eval_formulation(monkeypatch):
    """AAGCN at eval runs `eval_formulation or 'agg'` even when trained
    with 'pallas' (agcn_tpu aagcn.py:160-162): the GCN kernel's wrapper is
    reached at eval only with eval_formulation pallas, and in train
    mode with formulation pallas."""
    calls = []
    forward = gcn_fused.gcn_forward
    monkeypatch.setattr(gcn_fused, "gcn_forward",
                        lambda *a: calls.append(a[0]) or forward(*a))
    variables = _variables(model_layers=3)
    x = torch.from_numpy(_x(t=8))
    want = {}
    for eval_form, train, launched in ((None, False, 0),
                                       ("pallas", False, 3),
                                       (None, True, 3)):
        calls.clear()
        model = _port(variables, model_layers=3, formulation="pallas",
                      eval_formulation=eval_form).train(train)
        with torch.no_grad():
            out = model(x).numpy()
        assert len(calls) == launched, (eval_form, train)
        if not train:
            want[eval_form] = out
    # both eval forms compute the same function
    np.testing.assert_allclose(want["pallas"], want[None], atol=2e-4)
    jax_out, _ = _jax_logits(variables, x.numpy(), model_layers=3,
                             formulation="pallas")
    np.testing.assert_allclose(want[None], jax_out, atol=2e-4)


def test_dropout_draws_from_the_model_generator():
    kw = dict(model_layers=3, drop_out=0.5)
    variables = _variables(**kw)
    x = torch.from_numpy(_x(t=8))
    want, _ = _jax_logits(variables, x.numpy(), **kw)
    outs = []
    for _ in range(2):
        model = _port(variables, generator=torch.Generator().manual_seed(4),
                      **kw)
        with torch.no_grad():
            np.testing.assert_allclose(model.eval()(x).numpy(), want,
                                       atol=2e-4)  # no dropout at eval
            outs.append([model.train()(x) for _ in range(2)])
    assert torch.equal(outs[0][0], outs[1][0])  # seeded
    assert not torch.equal(outs[0][0], outs[0][1])  # fresh masks


# -- training ------------------------------------------------------------

_SCHED = (0.1, 4, [2], 1)  # base lr, steps/epoch, decay epochs, warmup


@pytest.mark.parametrize("form", ["pallas", "agg_packed"])
def test_one_train_step_matches_jax(form):
    """Loss, accuracy and every raw gradient of one step, then the updated
    parameters and BN statistics (SGD nesterov, clip 1.0, decay 1e-4)."""
    kw = dict(model_layers=3, formulation=form)
    variables = _variables(condition=True, **kw)
    rng = np.random.default_rng(1)
    x = _x(seed=4)
    y = rng.integers(0, NUM_CLASS, (2,))
    jmodel = JaxAAGCN(num_class=NUM_CLASS, adj=ADJ, **kw)
    tx = joptim.sgd_nesterov(joptim.warmup_step_schedule(*_SCHED),
                             weight_decay=1e-4, nesterov=True, grad_clip=1.0)
    state = TrainState.create(jmodel.apply, variables["params"],
                              variables["batch_stats"], tx)

    def loss_of(params):
        (logits, _), _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy(logits, jnp.asarray(y))

    jstep = make_train_step(jlosses.cross_entropy)

    @jax.jit
    def grads_and_step(state):
        return jax.grad(loss_of)(state.params), jstep(
            state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))

    jgrads, (new_state, jm) = grads_and_step(state)

    model = _port(variables, **kw)
    opt = toptim.SGDNesterov(model.parameters(),
                             toptim.warmup_step_schedule(*_SCHED),
                             weight_decay=1e-4, nesterov=True, grad_clip=1.0)
    raw = {}
    step = port_train_step(model, tlosses.cross_entropy, opt,
                           grad_transform=lambda m: raw.update(
                               (n, p.grad.clone())
                               for n, p in m.named_parameters()))
    m = step(torch.from_numpy(x), torch.from_numpy(y))
    want_grads = aagcn_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]})
    assert len(raw) > 0
    for name, g in raw.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               atol=2e-4, rtol=0)
    assert m["acc"].item() == float(jm["acc"])
    want = aagcn_state_dict_from_variables(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params,
                     "batch_stats": new_state.batch_stats}))
    for name, value in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       atol=2e-4, rtol=0, err_msg=name)


def _frames(seed, n_frames=40):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 1, 25, 3)).astype(np.float32) * 0.2
            for _ in range(n_frames)]


def test_port_server_answers_as_jax_server():
    """Same frames, same weights: the same labels, probabilities within
    1e-4, on the kernel form at eval."""
    kw = dict(model_layers=3, formulation="pallas",
              eval_formulation="pallas")
    variables = _variables(**kw)
    jmodel = JaxAAGCN(num_class=NUM_CLASS, adj=ADJ, **kw)
    tmodel = _port(variables, **kw).eval()
    kwargs = dict(max_seq_length=32, moving_avg=2,
                  allowed_classes=[0, 2, 3, 5])
    jserver = JaxServer(jmodel, variables, max_streams=3, kind="dense",
                        **kwargs)
    tserver = BatchedStreamServer(tmodel, max_streams=3, **kwargs)
    for sid in range(3):
        assert jserver.add_stream() == tserver.add_stream() == sid
        for f in _frames(sid + 20):
            jserver.append_frame(sid, f)
            tserver.append_frame(sid, f)
    want, got = jserver.predict(), tserver.predict()
    assert set(want) == set(got) == {0, 1, 2}
    for sid in want:
        assert got[sid][0] == want[sid][0]
        np.testing.assert_allclose(got[sid][1], want[sid][1], atol=1e-4)


_STEP = re.compile(r"epoch (\d+) step (\d+)/\d+ loss ([-\d.]+)")


def test_port_trainer_tracks_the_jax_trainer(tmp_path):
    """`agcn_tpu_torch.main --device cpu` on an AAGCN recipe against the
    JAX Trainer, both from one npz the JAX package saved: the losses of
    two epochs, the first with the PA gradients zeroed by name
    (only_train_part), and each epoch's top-1."""
    n, t, num_class = 16, 16, 4
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, 3, t, 25, 2)).astype(np.float32) * 0.5
    labels = (np.arange(n) % num_class).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += 0.5 * label
    np.save(tmp_path / "data.npy", data)
    with open(tmp_path / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels), f)
    feeder = {"data_path": str(tmp_path / "data.npy"),
              "label_path": str(tmp_path / "label.pkl"), "window_size": t}
    args = {"num_class": num_class, "graph": "ntu_rgb_d", "model_layers": 3,
            "formulation": "pallas"}
    model = AAGCN(num_class=num_class, adj=ADJ, device="cpu",
                  model_layers=3, generator=torch.Generator().manual_seed(3))
    variables = _randomize(aagcn_variables_from_torch(model.state_dict()),
                           seed=3, condition=True)
    init = str(tmp_path / "init")
    save_checkpoint(init, variables, use_orbax=False)

    def recipe(work):
        return {"work_dir": str(tmp_path / work), "model": "aagcn",
                "model_args": args, "train_feeder_args": feeder,
                "test_feeder_args": feeder, "batch_size": 4,
                "test_batch_size": 8, "num_epoch": 2, "eval_interval": 1,
                "save_interval": 1, "base_lr": 0.05, "log_interval": 1,
                "seed": 7, "print_log": False, "mesh_data": 1,
                "num_worker": 0, "only_train_part": True,
                "only_train_epoch": 0, "device": "cpu"}

    cfg = JaxConfig()
    for key, value in dict(recipe("jax"), weights=init).items():
        setattr(cfg, key, value)
    JaxTrainer(cfg).start()
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(recipe("port")))
    port_main(["--config", str(path), "--weights", init])

    def steps(work):
        with open(tmp_path / work / "log.txt") as f:
            return [(int(m[1]), int(m[2]), float(m[3]))
                    for m in _STEP.finditer(f.read())]

    def evals(work):
        with open(tmp_path / work / "metrics.jsonl") as f:
            return [r["top1"] for r in map(json.loads, f)
                    if r["kind"] == "eval"]

    want, got = steps("jax"), steps("port")
    assert len(got) == 8 and [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-3)
    assert evals("port") == evals("jax") and len(evals("port")) == 2
    assert os.path.exists(tmp_path / "port" / "checkpoints" / "epoch_2.pt")


def test_exact_zero_gradients_are_zero_in_float64():
    """The gradient-parity bar (agcn_tpu_torch/tools/grad_parity.py) holds
    the conv biases before a BN, and conv_a's under the softmax, to a
    rounding floor: in AAGCN too they are zero in exact arithmetic, and
    no other bias is."""
    from agcn_tpu_torch.tools import grad_parity as gp

    model = build_model("aagcn", dict(num_class=7, formulation="pallas"),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    gp.condition_bn(model, 1)
    model = model.double()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # the attention branch live (zero at init)
        for name, p in model.named_parameters():
            if name.endswith(".alpha"):
                p.fill_(0.7)
            elif ".conv_ta." in name or ".fc2c." in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    x = torch.randn(2, 3, 16, 25, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    with gp.float_keeps_float64():
        _, grads = gp.step_grads(model, tlosses.cross_entropy, x,
                                 torch.tensor([1, 3]))
    top = max(g.abs().max().item() for g in grads.values())
    zero = {n: g.abs().max().item() for n, g in grads.items()
            if gp.EXACT_ZERO.search(n)}
    # conv_a, conv_d, down, tcn and residual conv biases of ten blocks
    assert len(zero) == 75
    assert max(zero.values()) <= 1e-12 * top
    others = [g.abs().max().item() for n, g in grads.items()
              if n.endswith(".bias") and n not in zero]
    assert min(others) > 1e-9 * top


def test_cli_serves_the_aagcn_recipe_on_cpu(tmp_path, capsys):
    """python -m agcn_tpu_torch.infer --serve with
    configs/ntu60_xview/test_joint_aagcn.yaml (full width) on the CPU,
    weights from a .pt state dict."""
    from agcn_tpu_torch.infer.cli import main as cli_main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rec = tmp_path / "rec"
    rec.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        np.save(rec / f"cam{i}.npy",
                rng.standard_normal((3, 16, 25, 2)).astype(np.float32))
    model = build_model("aagcn", {"num_class": 60}, device="cpu")
    torch.save(model.state_dict(), tmp_path / "w.pt")
    cli_main(["--config", os.path.join(repo, "configs", "ntu60_xview",
                                       "test_joint_aagcn.yaml"),
              "--weights", str(tmp_path / "w.pt"), "--input", str(rec),
              "--serve", "2", "--interval", "8", "--max-frame", "16",
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[cam") for ln in lines) == 2 * 2
