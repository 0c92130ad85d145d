"""The port's SGN (agcn_tpu_torch/models/sgn.py) against agcn_tpu's on the
CPU: `train_sgn.yaml`'s model at full width (batch 4), at the Kinetics
shape (V = 18, 400 classes) and at seg 30; small-width option cases; the
per-frame ops; strict loads of every option value once refused; the
registry against the JAX registry; the dropout2d generator.

Weights move JAX -> port through the port's
`sgn_state_dict_from_variables` with a strict load. Every unit's w1 is
made random first (its init is zero, which would leave the G path
adding nothing), and the BN statistics are the JAX model's after a
train-mode forward.

Tolerances: the model's fp32 logits 2e-4 (ROADMAP's bar); one train
step's loss 2e-4 relative and every gradient 2e-4 of its tensor's scale
(dropout 0; fp32 sums in other orders); the per-frame ops 1e-6.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.models import registry as jax_registry
from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.train import losses as jlosses
from agcn_tpu.utils.torch_export import \
    sgn_state_dict_from_variables as jax_export
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.models.sgn import SGN
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops.attention import Dropout
from agcn_tpu_torch.tools.grad_parity import EXACT_ZERO
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.utils.weights import (model_state_dict,
                                          sgn_state_dict_from_variables)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"ntu": "ntu60_xview/train_sgn.yaml",
           "kinetics": "kinetics/train_sgn.yaml",
           "seg30": "grid_sgn/train_seg30_drop0.2.yaml"}
BATCH = 4


def _recipe_args(name):
    with open(os.path.join(REPO, "configs", RECIPES[name])) as f:
        recipe = yaml.safe_load(f)
    return recipe["model_args"], recipe["train_dataloader_args"]["seg"]


def _x(seg, v, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BATCH, seg, v * 3)).astype(np.float32)


def _jax_variables(model_args, seg, v, seed=0):
    """The JAX model, its init with every unit's w1 random, and the BN
    statistics of one train-mode forward (random ones let the logits grow
    past the bar's scale)."""
    model = jax_registry.build_model("sgn", model_args)
    x = jnp.asarray(_x(seg, v, seed + 1))
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(seed), x)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.default_rng(seed)
    for unit in params["sgcn"].values():
        if "w1" in unit:
            k = unit["w1"]["kernel"]
            unit["w1"]["kernel"] = (rng.standard_normal(k.shape)
                                    / np.sqrt(k.shape[0])).astype(np.float32)
    train_forward = jax.jit(functools.partial(
        model.apply, train=True, mutable=["batch_stats"]))
    stats = train_forward({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x)[1]["batch_stats"]
    stats = jax.tree_util.tree_map(np.array, stats)
    return model, {"params": params, "batch_stats": stats}


def _jax_logits(model, variables, x):
    return np.asarray(jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.asarray(x))[0])


def _port(model_args, variables, seg):
    model = registry.build_model("sgn", model_args, device="cpu",
                                 num_frame=seg)
    model.load_state_dict(sgn_state_dict_from_variables(variables),
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _case(name):
    args, seg = _recipe_args(name)
    args = dict(args, dropout2d=0.0)
    v = args["num_point"]
    model, variables = _jax_variables(args, seg, v)
    return args, seg, v, model, variables


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_logits_match_jax(name):
    args, seg, v, model, variables = _case(name)
    port = _port(args, variables, seg).eval()
    x = _x(seg, v, 2)
    want = _jax_logits(model, variables, x)
    with torch.no_grad():
        got, g_list = port(torch.from_numpy(x), return_g=True)
    assert got.shape == (BATCH, args["num_class"])
    assert len(g_list) == 1 and g_list[0].shape == (BATCH, seg, v, v)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_train_step_gradients_match_jax(name, monkeypatch):
    """One train-mode forward (batch statistics), the recipe's label
    smoothing, backward: the loss and every parameter's gradient, the
    JAX gradients brought to torch names by the same map. The port
    replays the JAX forward's ReLU masks: one of the ~10^6 ReLU inputs may
    lie within fp32 rounding of zero and take the other sign in the other
    framework, which moves every gradient below it past the bar (at seg
    30 the JAX package's fp32 gradients stand 6% off a float64 step of the
    port, whose own fp32 step is within 2e-5 of it). The two frameworks'
    ReLU inputs must lie within 1e-3 of their layer's mean |input|
    (the bar of chip_smoke's card-against-CPU steps)."""
    import flax.linen

    from agcn_tpu_torch.tools.grad_parity import ReluProbe, relu_probe

    args, seg, v, model, variables = _case(name)
    port = _port(args, variables, seg).train()
    x = _x(seg, v, 3)
    y = np.random.default_rng(3).integers(0, args["num_class"], BATCH)
    jloss_fn = jlosses.build_loss("ce", args["num_class"], smoothing=0.1)

    def loss_of(params):
        # flax's nn.relu, recording each call's input in call order
        inputs = []
        monkeypatch.setattr(flax.linen, "relu",
                            lambda z: inputs.append(z) or jax.nn.relu(z))
        logits, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
        monkeypatch.undo()
        return jloss_fn(logits, jnp.asarray(y)), inputs

    (want_loss, inputs), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    want = sgn_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": variables["batch_stats"]})
    relus = types.SimpleNamespace(
        inputs=[torch.from_numpy(np.asarray(z)) for z in inputs])
    relus.masks = [z > 0 for z in relus.inputs]
    probe = ReluProbe(ref=relus)
    with relu_probe(probe):
        loss = tlosses.build_loss("ce", args["num_class"], smoothing=0.1)(
            port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert len(probe.masks) == len(relus.masks) == 13
    assert probe.input_diff <= 1e-3, probe.input_diff
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    top = max(w.abs().max().item() for w in want.values())
    for name_, p in port.named_parameters():
        if name_.endswith(".alpha"):
            # unused without a prior G: JAX gives it a zero gradient, the
            # train step fills it so (steps.make_train_step)
            assert p.grad is None and not np.any(np.asarray(want[name_]))
            continue
        scale = want[name_].abs().max().item()
        err = (p.grad - want[name_]).abs().max().item()
        # gradients zero in exact arithmetic (a BN follows the bias, or
        # the softmax is invariant to it) come out as rounding noise of
        # the other gradients' size (tools/grad_parity.grad_errors)
        bar = (1e-5 * top if EXACT_ZERO.search(name_)
               else 2e-4 * scale + 1e-7 * top)
        assert err <= bar, (name_, err, scale)


def test_reference_export_and_jax_tree_load_strict(tmp_path):
    """The port's map gives the JAX package's reference export (names,
    shapes and values: 80 entries, 57 parameters, the one-hot buffers);
    a reference `.pt` and a JAX npz checkpoint both load strictly."""
    from agcn_tpu.train.checkpoint import save_checkpoint
    from agcn_tpu_torch.train.checkpoint import load_checkpoint

    args, seg, v, _, variables = _case("ntu")
    got = sgn_state_dict_from_variables(variables)
    want = jax_export(variables)
    assert sorted(got) == sorted(want) and len(got) == 80
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    port = _port(args, variables, seg)
    assert sum(1 for _ in port.parameters()) == 57
    assert sum(p.numel() for p in port.parameters()) == 810_921
    assert tuple(port.state_dict()["tem_mlp_3_1_k3.cnn.cnn1.block.conv"
                                   ".conv.weight"].shape) == (256, 256, 1, 3)
    torch.save({k: torch.from_numpy(np.array(w)) for k, w in want.items()},
               tmp_path / "sgn_v14.pt")
    save_checkpoint(str(tmp_path / "jax"), variables, use_orbax=False)
    for path in ("sgn_v14.pt", "jax"):
        sd = load_checkpoint(str(tmp_path / path), "model.sgn_v14.SGN",
                             args)["model"]
        SGN(device="cpu", **registry.sgn_args(args)).load_state_dict(
            sd, strict=True)


SMALL = dict(num_class=5, c_multiplier=0.25, sgcn_dims=[16, 32, 32],
             sgcn_g_proj_dim=16, multi_t=[[], [], [3]])


@pytest.mark.parametrize("options", [
    dict(sgcn_g_proj_dim=[16, 8, 16], semantic_joint_fusion=1,
         sgcn_gt_act=2),
    dict(input_position=3, input_velocity=12, bias=0,
         multi_t=[[], [], [3, 5]], sgcn_g_proj_shared=True),
    dict(input_position=2, input_velocity=11, in_channels=2,
         c_multiplier=[0.25, 0.5, 0.5, 0.25], sgcn_dims=None,
         sgcn_g_proj_dim=None),
    dict(semantic_joint=0, semantic_frame=0, input_velocity=0),
])
def test_small_options_match_jax(options):
    """The options of the base model at small widths: per-unit G, sum
    fusion and the sigmoid GT; embedding modes 3 and 12, no bias, two
    temporal kernels, shared g1/g3 projections; mode 2's residual
    projections, mode 11, in_channels 2 of 3, the default widths; one
    stream without the semantic tables."""
    args = dict(SMALL, **options)
    model, variables = _jax_variables(args, 20, 25, seed=5)
    port = _port(args, variables, 20)
    x = _x(20, 25, 6)
    want = _jax_logits(model, variables, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_frame_ops_match_jax():
    rng = np.random.default_rng(0)
    g1, g2, x = (rng.standard_normal((2, 5, 25, 8)).astype(np.float32)
                 for _ in range(3))
    for act in ("softmax", "sigmoid", "identity"):
        got = tgcn.frame_attention(torch.from_numpy(g1), torch.from_numpy(g2),
                                   act)
        want = jgcn.frame_attention(jnp.asarray(g1), jnp.asarray(g2), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    g = np.array(jgcn.frame_attention(jnp.asarray(g1), jnp.asarray(g2)))
    got = tgcn.frame_aggregate(torch.from_numpy(x), torch.from_numpy(g))
    want = jgcn.frame_aggregate(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# the option values once refused, each with what it needs to build (GT5's
# head as wide as the branches, GT6's level its own multi_t entry, per-unit
# G for g_weighted): the GCN stack's and head's, then the input side's
PORTED = [
    dict(sgcn_gt_mode=0), dict(sgcn_gt_mode=5, sgcn_gt_out_channels2=128),
    dict(sgcn_attn_mode=2), dict(gcn_fpn_output_merge=2),
    dict(gcn_fpn=10), dict(sgcn_gt_mode=6, multi_t=[[], [], [3], [3]]),
    dict(sgcn_ffn=4.0), dict(sgcn_residual=[1, 1, 1]),
    dict(sgcn_prenorm=True),
    dict(sgcn_g_weighted=True, sgcn_g_proj_dim=[16, 8, 16]),
    dict(sgcn_v_kernel=3), dict(sgcn_kernel=3, sgcn_padding=1),
    dict(sgcn_g_kernel=3), dict(sgcn_attn_mode=1), dict(spatial_maxpool=3),
    dict(temporal_maxpool=2), dict(spatial_maxpool=0),
    dict(spatial_maxpool=5), dict(temporal_maxpool=0),
    dict(temporal_maxpool=3), dict(sgcn_attn_mode=10),
    dict(sgcn_attn_mode=3),
    dict(semantic_jdiff=1), dict(semantic_joint_smp=1),
    dict(semantic_frame_location=1), dict(xem_projection=1),
    dict(input_position=1001, input_velocity=1001),
]


@pytest.mark.parametrize("option", PORTED)
def test_ported_option_loads_jax_variables_strict(option):
    """Each option value builds at small widths, the JAX model's variables
    (from `jax.eval_shape` plus seeded values: no compiled program) load
    strictly through the port's map, which holds every key of the JAX
    export with its value (the JAX export of attn_mode 3, whose units have
    no w1, raises KeyError; it has no key for jdiff's, xem_projection's
    and joint_smp's embeddings, which the port's map names), and an eval
    forward gives finite logits."""
    from tests.test_torch_port_sgn_options import _fill

    args = dict(SMALL, **option)
    x = _x(20, 25, 7)[:2]
    model = jax_registry.build_model("sgn", args)
    variables = _fill(jax.eval_shape(model.init, {
        "params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x)), 3)
    got = sgn_state_dict_from_variables(variables)
    if option.get("sgcn_attn_mode") == 3:
        with pytest.raises(KeyError, match="w1"):
            jax_export(variables)
    else:
        for k, w in jax_export(variables).items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    port = registry.build_model("sgn", args, device="cpu", num_frame=20)
    port.load_state_dict(got, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert out.shape == (2, 5) and bool(torch.isfinite(out).all())


def test_reference_files_with_dead_modules_load_as_in_jax(tmp_path):
    """A reference `.pt` of gcn_fpn 10 carries the second stack's unused G
    modules (`sgcn2.gcn_g*`), one of gcn_fpn_output_merge 2 more `fc{i}`
    heads than outputs (torch_export.py:318-322): neither loads strictly,
    as in JAX; `--weights` (`load_model_weights`) skips those keys,
    logging each, and loads every other."""
    from agcn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 load_model_weights)

    args = dict(SMALL, gcn_fpn=10, gcn_fpn_output_merge=2)
    port = registry.build_model("sgn", args, device="cpu")
    state = {k: torch.randn(v.shape) if v.is_floating_point() else v
             for k, v in port.state_dict().items()}
    dead = {"sgcn2.gcn_g1.g1.block.conv.conv.weight": torch.ones(16, 32, 1,
                                                                 1),
            "sgcn2.gcn_g1.alpha": torch.zeros(1),
            "fc2.weight": torch.ones(5, 128), "fc2.bias": torch.ones(5)}
    torch.save(dict(state, **dead), tmp_path / "ref.pt")
    sd = load_checkpoint(str(tmp_path / "ref.pt"), "sgn", args)["model"]
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port.load_state_dict(sd, strict=True)
    lines = []
    load_model_weights(port, sd, log=lines.append)
    assert sorted(lines) == sorted(f"unexpected weight skipped: {k}"
                                   for k in dead)
    for k, v in port.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_argmax_pool_takes_the_first_frame_of_a_tie():
    """temporal_maxpool 2 adds the projection of the argmax frame to the
    max over the frames: after a ReLU a channel may be 0 on every frame,
    and both frameworks then take frame 0 (torch documents the first
    index on the CPU and on CUDA; chip_smoke's phase 23 checks the card);
    a tie of two frames takes the first of them. The port's pool on such
    a tensor equals the max plus the projection of JAX's argmax."""
    port = registry.build_model("sgn", dict(SMALL, temporal_maxpool=2),
                                device="cpu")
    y = np.zeros((2, 6, 1, 128), np.float32)
    y[0, 4, 0, 1] = 0.5
    y[1, 2, 0, 2] = y[1, 5, 0, 2] = 0.5
    idx = np.asarray(jnp.argmax(jnp.asarray(y), axis=1, keepdims=True))
    assert idx[0, 0, 0, :3].tolist() == [0, 4, 0]
    assert idx[1, 0, 0, :3].tolist() == [0, 0, 2]
    with torch.no_grad():
        got = port._temporal_pool(torch.from_numpy(y))
        want = torch.from_numpy(y.max(axis=1, keepdims=True)) \
            + port.tmp_ind_projection(torch.from_numpy(idx).float())
    assert torch.equal(got, want)

def test_every_alias_builds_sgn():
    names = ["sgn", "SGN"] + [f"{p}sgn_{v}.SGN" for v in
                              ("v11", "v12", "v13", "v14")
                              for p in ("model.", "model.architecture.sgn.")]
    for name in names:
        model = registry.build_model(name, SMALL, device="cpu")
        assert isinstance(model, SGN), name
        assert registry.waiting_item(name) is None
    with pytest.raises(TypeError, match="no_such_option"):
        registry.build_model("sgn", dict(SMALL, no_such_option=1),
                             device="cpu")


UNPORTED = ["aagcn_v29", "sgn_v99", "model.aagcn_v5.Model",
            "model.architecture.aagcn.aagcn_v2.Model", "no_such_model"]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_names_raise_what_jax_raises(name):
    """A name the JAX package does not build raises the same exception
    type in both registries (and the same for a JAX checkpoint of it);
    only the JAX package's own models that the port lacks name an item."""
    with pytest.raises(Exception) as jax_err:
        jax_registry.build_model(name, {})
    with pytest.raises(Exception) as port_err:
        registry.build_model(name, {}, device="cpu")
    assert type(port_err.value) is type(jax_err.value) is KeyError
    if name.startswith("model."):
        assert "archived reference experiment" in str(port_err.value)
    assert registry.waiting_item(name) is None
    with pytest.raises(KeyError):
        model_state_dict({"params": {}, "batch_stats": {}}, name)


@pytest.mark.parametrize("name,item", [
    ("aagcn_v17", "item 6"), ("aagcn_v34", "item 6"),
    ("model.architecture.aagcn.aagcn_v31.Model", "item 6"),
    ("sgn_original", "item 7.2"), ("model.sgn.SGN", "item 7.2"),
    ("sgn_transformer", "item 7.3"), ("model.sgn_v15.SGN", "item 7.3"),
])
def test_jax_models_the_port_lacks_name_their_item(name, item):
    """The JAX models that once waited in an item (the AAGCN versions,
    item 6; the original SGN, item 7.2; SGN's transformer, item 7.3) are
    ported: none waits, and each builds where the JAX package builds
    it."""
    jax_registry.build_model(name, {})  # the JAX package builds them
    assert registry.waiting_item(name) is None
    assert registry.build_model(name, {"model_layers": 101} if
                                item == "item 6" else {},
                                device="cpu") is not None


def test_dropout2d_draws_whole_channels_from_the_generator():
    """dropout2d drops whole channels of a sample, drawn from the model's
    generator: the same seed gives the same masks, and the train step's
    reseed (`seed_dropout`) makes a step's masks a function of its count."""
    from agcn_tpu_torch.train.steps import seed_dropout

    model = registry.build_model("sgn", dict(SMALL, dropout2d=0.5),
                                 device="cpu")
    drops = [m for m in model.modules()
             if isinstance(m, Dropout) and m.p > 0]
    assert len(drops) == 1 and drops[0].generator is model.dropout_generator
    drop = drops[0].train()
    x = torch.ones(8, 20, 1, 64)
    seed_dropout(model, 3)
    y = drop(x)
    kept = (y != 0)
    assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
    assert 0 < kept[:, 0, 0].float().mean() < 1
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    seed_dropout(model, 3)
    assert torch.equal(drop(x), y)
    seed_dropout(model, 4)
    assert not torch.equal(drop(x), y)
    assert registry.build_model("sgn", SMALL, device="cpu") \
        .dropout_generator is None
