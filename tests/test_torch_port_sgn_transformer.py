"""The port's SGN transformer (agcn_tpu_torch/models/sgn_transformer.py)
and its lucid layers (agcn_tpu_torch/ops/attention.py) against agcn_tpu's
on the CPU: each lucid layer option, the boolean attention mask, the
logits of both recipes (`train_sgn_transformer.yaml`: torch-style
encoders; `train_sgn_v15.yaml`: the lucid encoder), of a mixed config and
of small option configs, the weight maps and loads, and one Adam step.

Weights move JAX -> port through `sgn_transformer_state_dict_from_variables`
with a strict load; BN statistics are those of a JAX train-mode forward.
Tolerances: logits and activations 2e-4 (ROADMAP's fp32 bar); the step's
loss 1e-5 relative and every gradient 2e-4 of its tensor's scale (1e-5 of
the largest gradient for those zero in exact arithmetic), the max-pool
selections and ReLU masks of the JAX forward replayed.
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
from agcn_tpu.models import sgn_transformer as jax_sgn_transformer
from agcn_tpu.ops import attention as jattn
from agcn_tpu.train import losses as jlosses
from agcn_tpu.utils import torch_import
from agcn_tpu.utils.torch_export import \
    sgn_transformer_state_dict_from_variables as jax_export
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.models.sgn_transformer import LucidMHA, SGNTransformer
from agcn_tpu_torch.ops import attention as tattn
from agcn_tpu_torch.tools.grad_parity import (EXACT_ZERO, AmaxProbe,
                                              ReluProbe, amax_probe,
                                              relu_probe)
from agcn_tpu_torch.utils import weights
from agcn_tpu_torch.utils.weights import \
    sgn_transformer_state_dict_from_variables as port_map
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"generic": "train_sgn_transformer.yaml", "v15": "train_sgn_v15.yaml"}
SEG = 20


def _recipe_args(name):
    with open(os.path.join(REPO, "configs", "ntu60_xview",
                           RECIPES[name])) as f:
        return yaml.safe_load(f)["model_args"]


def _x(batch, seed, channels=3, v=25):
    return np.random.default_rng(seed).standard_normal(
        (batch, SEG, v * channels)).astype(np.float32)


def _no_dropout(args):
    args = dict(args, dropout=0.0)
    for k in ("spatial_mha_kwargs", "temporal_mha_kwargs"):
        if k in args:
            args[k] = dict(args[k], dropout=0.0)
    return args


# the backend's cheapest optimization level: each JAX program below is
# one compile, in a fraction of the default level's time
FAST = {"xla_backend_optimization_level": 0}


def jax_fast(fn, *args):
    """fn(*args) as one jitted program compiled with FAST, in numpy."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _seeded_variables(model, x, seed):
    """The JAX model's variables from `jax.eval_shape` of its init (no
    init program to compile), the values drawn with numpy: kernels
    U(+-1/sqrt(fan_in)) (torch's default), norm scales 1 +- 0.1, biases
    +- 0.1, running statistics 0 and 1."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("mean", "var"):
            return np.full(s.shape, float(name == "var"), np.float32)
        else:
            bound = 0.1
        u = rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return u + 1.0 if name == "scale" else u

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _with_stats(model, variables, x):
    """`variables` with the BN statistics of one train-mode forward."""
    stats = model.apply(variables, x, train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(1)}
                        )[1]["batch_stats"]
    return {"params": variables["params"], "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(args, JAX model, variables, its eval output on `_x(2, 4)`) of a
    recipe, or of a config below: one JAX program."""
    args = _recipe_args(name) if name in RECIPES else CONFIGS[name]
    model = jax_registry.build_model("sgn_transformer", args)
    c = args.get("in_channels", 3)
    x = jnp.asarray(_x(2, 1, c))

    def run(variables, x, x_eval):
        variables = _with_stats(model, variables, x)
        return variables, model.apply(variables, x_eval, train=False)

    variables, out = jax_fast(run, _seeded_variables(model, x, 0), x,
                              jnp.asarray(_x(2, 4, c)))
    return args, model, variables, out


def _port(args, variables):
    model = registry.build_model("sgn_transformer", args, device="cpu",
                                 num_frame=SEG)
    model.load_state_dict(port_map(variables), strict=True)
    return model


# -- the lucid layers -----------------------------------------------------

LAYER_CASES = {
    # BN pre-norm, relu, per-layer lists, d_out != d_model, residuals
    "bn_pre": dict(num_layers=2, d_model=[16, 32], nhead=[2, 1],
                   d_head=[8, 24], dim_feedforward=[40, 24],
                   dim_feedforward_output=[32, 0], d_out=[24, 32],
                   norm="bn", activation="relu", global_norm=True),
    # LN post-norm, gelu, res_proj, no global norm
    "ln_post": dict(num_layers=1, d_model=16, nhead=4, d_head=4,
                    dim_feedforward=32, norm="ln", activation="gelu",
                    post_norm=True, res_proj=True, global_norm=False),
    # BN post-norm with a global norm; LN pre-norm with res_proj
    "bn_post": dict(num_layers=1, d_model=16, nhead=2, d_head=8,
                    dim_feedforward=24, dim_feedforward_output=20,
                    norm="bn", activation="gelu", post_norm=True),
    "ln_pre": dict(num_layers=2, d_model=16, nhead=2, d_head=8,
                   dim_feedforward=24, norm="ln", activation="relu",
                   res_proj=True, global_norm=True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_lucid_transformer_matches_jax(case):
    """Tokens and attention weights of a train-mode forward (batch
    statistics), the running statistics it leaves, and an eval forward on
    them."""
    kw = LAYER_CASES[case]
    x = np.random.default_rng(2).standard_normal((3, 7, 16)).astype(
        np.float32)
    jmod = jattn.LucidTransformer.from_mha_kwargs(kw, name=None)

    def run(key, x):
        variables = jmod.init(key, x)
        train_out, upd = jmod.apply(variables, x, True,
                                    mutable=["batch_stats"])
        return (variables, train_out,
                jmod.apply(dict(variables, **upd), x, False)[0])

    variables, (want_y, want_a), want_e = jax_fast(
        run, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    sd = {}
    weights._lucid_out(sd, "m", variables["params"],
                       variables.get("batch_stats", {}))
    port = LucidMHA(kw, 16)
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    got_y, got_a = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_y.detach().numpy(), want_y, atol=2e-4)
    assert len(got_a) == len(want_a) == kw["num_layers"]
    for g, w in zip(got_a, want_a):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=2e-4)
    with torch.no_grad():
        got_e, _ = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_e.numpy(), want_e, atol=2e-4)


def test_multihead_attention_mask_matches_jax():
    """The boolean mask: logits where it is False set to -1e9 (a row with
    one key kept, a causal pattern, a per-head mask)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 8)).astype(np.float32)
    mask = np.tril(np.ones((6, 6), bool))[None, None] & (
        rng.random((2, 2, 6, 6)) > 0.3)
    mask[..., 0] = True
    jmod = jattn.MultiheadAttention(num_heads=2)
    variables, (want_y, want_a) = jax_fast(
        lambda k, q, m: (lambda v: (v, jmod.apply(v, q, mask=m)))(
            jmod.init(k, q)),
        jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(mask))
    p = variables["params"]
    port = tattn.MultiheadAttention(8, 2)
    port.load_state_dict({
        "in_proj_weight": torch.from_numpy(p["in_proj_kernel"].T.copy()),
        "in_proj_bias": torch.from_numpy(p["in_proj_bias"]),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"])})
    with torch.no_grad():
        got_y, got_a = port(torch.from_numpy(q), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_a.numpy(), want_a, atol=1e-6)
    assert not got_a.numpy()[~np.broadcast_to(mask, got_a.shape)].any()
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=2e-5)


# -- the model ------------------------------------------------------------

CONFIGS = {
    # tests/test_transformer_models.py's mixed encoders: lucid spatial,
    # torch-style temporal
    "mixed": dict(num_class=7, spatial_mha_kwargs=dict(
        d_model=[128], nhead=[1], dim_feedforward=[512], dropout=0.1,
        activation="relu", num_layers=1, d_head=[512],
        dim_feedforward_output=[256], norm="bn", global_norm=False),
        temporal_mha_kwargs=dict(num_layers=2, nhead=4)),
    # c_multiplier 0.25: concatenated input streams summed with the joint
    # table, the frame table before a post-norm LN lucid spatial encoder,
    # no max-pools (flattened joints and frames), dropout, no bias
    "options_a": dict(
        num_class=5, c_multiplier=0.25, bias=0, dropout=0.2,
        input_emb_fusion=0, semantic_joint_fusion=1,
        semantic_frame_location=1, spatial_maxpool=0, temporal_maxpool=0,
        spatial_mha_kwargs=dict(num_layers=1, d_model=32, nhead=2, d_head=8,
                                dim_feedforward=32, dim_feedforward_output=8,
                                norm="ln", post_norm=True, res_proj=True,
                                activation="gelu", global_norm=True),
        temporal_mha_kwargs=dict(num_layers=1, nhead=2, dim_feedforward=64,
                                 pre_norm=True, activation="gelu",
                                 dropout=0.1)),
    # a torch-style spatial encoder, a two-layer BN lucid temporal one
    # (widths 32 -> 48 -> 128 -> 128) and the class table at c4
    "options_b": dict(
        num_class=5, c_multiplier=0.25, semantic_class=1,
        spatial_mha_kwargs=dict(num_layers=1, nhead=2),
        temporal_mha_kwargs=dict(
            num_layers=2, d_model=[32, 128], d_out=[48, 128], nhead=[2, 4],
            d_head=[8, 4], dim_feedforward=[64, 64],
            dim_feedforward_output=[128, 0], norm="bn", activation="relu")),
    # position alone, no frame table, mode-2 class table at the running
    # width of torch-style encoders, in_channels 2
    "options_c": dict(num_class=5, c_multiplier=0.25, input_velocity=0,
                      semantic_frame=0, semantic_class=2, in_channels=2),
}


@pytest.mark.parametrize("name", list(RECIPES) + list(CONFIGS))
def test_logits_match_jax(name):
    args, _, variables, (want, want_aux) = _case(name)
    port = _port(args, variables).eval()
    x = _x(2, 4, args.get("in_channels", 3))
    with torch.no_grad():
        got, aux = port(torch.from_numpy(x))
    assert got.shape == (2, args["num_class"])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    for k in ("spatial_attn", "temporal_attn"):
        assert len(aux[k]) == len(want_aux[k])
        for g, w in zip(aux[k], want_aux[k]):
            np.testing.assert_allclose(g.numpy(), w, atol=2e-4)


def test_weight_maps_and_strict_loads(tmp_path):
    """The port's map equals the JAX export on the lucid branch (names
    and values, one-hot buffers included); JAX npz checkpoints of both
    branches load strictly through the trainer's reader under every
    registry name; the port's v15 state dict goes back through JAX's
    import map to the same logits. JAX's trainer reads a `.pt` of any
    "sgn" model but sgn_original by the v14 map, which keeps the
    embeddings and fc and drops both encoders (ROADMAP Queue 3)."""
    from agcn_tpu.train.checkpoint import save_checkpoint
    from agcn_tpu_torch.train.checkpoint import load_checkpoint

    args, model, variables, _ = _case("v15")
    got, want = port_map(variables), jax_export(variables)
    assert sorted(got) == sorted(want) and len(got) == 72
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    for name in RECIPES:
        args_, _, vars_, _ = _case(name)
        save_checkpoint(str(tmp_path / name), vars_, use_orbax=False)
        for key in ("sgn_transformer", "model.sgn_v15.SGN",
                    "model.architecture.sgn.sgn_v15.SGN"):
            sd = load_checkpoint(str(tmp_path / name), key, args_)["model"]
            registry.build_model(key, args_, device="cpu").load_state_dict(
                sd, strict=True)
    port = _port(args, variables).eval()
    back = torch_import.sgn_transformer_variables_from_torch(
        port.state_dict())
    x = _x(2, 5)
    with torch.no_grad():
        mine = port(torch.from_numpy(x))[0].numpy()
    theirs = jax_fast(lambda v, x: model.apply(v, x, train=False)[0], back,
                      jnp.asarray(x))
    np.testing.assert_allclose(theirs, mine, atol=2e-4)
    v14 = torch_import.sgn_variables_from_torch(port.state_dict())
    assert "spatial_mha" not in v14["params"]
    assert "temporal_mha" not in v14["params"]


def test_registry_and_arguments():
    """The three names build where JAX builds them; the recipe-only
    arguments are checked as JAX checks them; nothing waits any more."""
    assert registry._WAITING == {}
    for name in ("sgn_transformer", "model.sgn_v15.SGN",
                 "model.architecture.sgn.sgn_v15.SGN"):
        assert registry.waiting_item(name) is None
        assert isinstance(registry.build_model(name, {"num_class": 5},
                                               device="cpu"),
                          SGNTransformer)
    assert "model.sgn_v15.SGN" in str(registry.unknown_model("model.x.Y"))
    args = _recipe_args("v15")
    model = registry.build_model("sgn_transformer", args, device="cpu",
                                 num_frame=30)
    assert model.num_segment == 30  # the loader's seg sizes the frame table
    # 2,579,496 at seg 20: the frame table's first layer takes 30 inputs
    assert sum(p.numel() for p in model.parameters()) == 2_582_056
    for bad in ({"norm_type": "ln"}, {"act_type": "gelu"},
                {"dropout2d": 0.2, "input_position": 101}):
        with pytest.raises(ValueError):
            jax_registry.build_model("sgn_transformer", bad)
        with pytest.raises(ValueError):
            registry.build_model("sgn_transformer", bad, device="cpu")
    with pytest.raises(ValueError, match="segments"):
        model(torch.zeros(1, SEG, 75))


def test_dropout_draws_from_the_model_generator():
    """The encoders' dropouts and fc's draw from the model's generator:
    the same seed gives the same train-mode logits, another seed others."""
    from agcn_tpu_torch.train.steps import seed_dropout

    args = _recipe_args("generic")
    x = torch.from_numpy(_x(2, 6))
    outs = []
    for step in (0, 0, 1):
        model = registry.build_model(
            "sgn_transformer", args, device="cpu",
            generator=torch.Generator().manual_seed(3)).train()
        seed_dropout(model, step)
        outs.append(model(x)[0].detach())
    assert model.dropout_generator is not None
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])


@pytest.mark.parametrize("name", list(RECIPES))
def test_adam_step_matches_jax(name):
    """One training step at batch 4, dropout 0, the recipe's label
    smoothing and Adam through the port's train step: the loss and every
    gradient the update takes against jax.value_and_grad of the JAX
    model, the JAX forward's max selections (the spatial and temporal
    max-pools) and ReLU masks replayed on the port; and the update moved
    every parameter."""
    from agcn_tpu_torch.train import losses as tlosses
    from agcn_tpu_torch.train import optim
    from agcn_tpu_torch.train.steps import make_train_step
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "ntu60_xview",
                                   RECIPES[name]))
    args = _no_dropout(_recipe_args(name))
    model = jax_registry.build_model("sgn_transformer", args)
    x = _x(4, 7)
    variables = _case(name)[2]
    y = np.array([0, 7, 7, 41])
    jloss_fn = jlosses.build_loss("ce", 60, smoothing=cfg.label_smoothing)

    class Recording:
        """jax.numpy for the JAX model's module, its max-pools recorded."""

        def __init__(self):
            self.maxes = []

        def __getattr__(self, name):
            return getattr(jnp, name)

        def max(self, z, axis=None):
            self.maxes.append((z, axis))
            return jnp.max(z, axis=axis)

    def loss_of(params):
        relus, rec = [], Recording()
        flax_relu = flax.linen.relu
        flax.linen.relu = lambda z: relus.append(z) or jax.nn.relu(z)
        jax_sgn_transformer.jnp = rec
        try:
            logits, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
        finally:
            flax.linen.relu, jax_sgn_transformer.jnp = flax_relu, jnp
        sel = [z == jnp.max(z, axis=a, keepdims=True) for z, a in rec.maxes]
        return jloss_fn(logits, jnp.asarray(y)), (relus, sel)

    # the default optimization level: at FAST, XLA's CPU backend gives
    # NaN gradients for the embeddings' BN (as for SGN's FPN projections)
    (want_loss, (relus, sels)), grads = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            variables["params"]))
    want = port_map({"params": grads,
                     "batch_stats": variables["batch_stats"]})
    relu_ref = types.SimpleNamespace(
        inputs=[torch.from_numpy(np.array(z)) for z in relus])
    relu_ref.masks = [z > 0 for z in relu_ref.inputs]
    amax_ref = types.SimpleNamespace(
        masks=[torch.from_numpy(np.array(s)) for s in sels])
    port = _port(args, variables)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    got = {}
    step = make_train_step(
        port, tlosses.build_loss("ce", 60, smoothing=cfg.label_smoothing),
        optim.from_config(cfg, port.named_parameters(), 1),
        grad_transform=lambda m: got.update(
            (n, p.grad.clone()) for n, p in m.named_parameters()))
    relu, amax = ReluProbe(ref=relu_ref), AmaxProbe(ref=amax_ref)
    with relu_probe(relu), amax_probe(amax):
        loss = step(torch.from_numpy(x), torch.from_numpy(y))["loss"].item()
    assert len(amax.masks) == len(sels) == 2
    assert len(relu.masks) == len(relus) > 8
    assert relu.input_diff <= 1e-3, relu.input_diff
    assert amax.disagree == 0
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    top = max(w.abs().max().item() for w in want.values())
    assert set(got) == set(before)
    for k, g in got.items():
        scale = want[k].abs().max().item()
        err = (g - want[k]).abs().max().item()
        bar = (1e-5 * top if EXACT_ZERO.search(k)
               else 2e-4 * scale + 1e-7 * top)
        assert err <= bar, (k, err, scale)
    moved = [k for k, p in port.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) == len(before)
