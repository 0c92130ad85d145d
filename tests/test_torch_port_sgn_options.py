"""The port's SGN options of the v11, v12 and v13_gt4 recipes, the MMD
loss with the InfoGCN head, and the original SGN, against agcn_tpu's on
the CPU: the recipes' eval logits at full width; the other GCN-FPN modes,
GT modes and residual scales at small widths; one v12 step with the MMD
loss; `mmd_loss` and its metrics against the JAX trainer's closure; the
strict loads; the prior's init; `sgn_original`'s logits, loads and step.

Weights move JAX -> port through the port's maps with a strict load.
Every unit's w1 is random (its init is zero), and the BN statistics are
the JAX model's after a train-mode forward. Each JAX program is one jit
compiled at the backend's cheapest optimization level.

Tolerances: fp32 logits 2e-4 (ROADMAP's bar); a step's loss 1e-4
relative and every gradient 2e-4 of its tensor's scale (the bars of
tests/test_torch_port_sgn.py), BN running statistics 1e-5 of their
scale; the MMD loss and its metrics 1e-5 relative.
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
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train.trainer import Trainer as JaxTrainer
from agcn_tpu.utils import torch_export
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.models.sgn_original import SGNOriginal
from agcn_tpu_torch.tools.grad_parity import (NoiseProbe, ReluProbe,
                                              grad_errors, noise_probe,
                                              relu_probe)
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train.trainer import build_aux_loss
from agcn_tpu_torch.utils.weights import (
    sgn_original_state_dict_from_variables, sgn_state_dict_from_variables)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
SEG = 20
FAST = {"xla_backend_optimization_level": 0}


def _recipe(name):
    with open(os.path.join(REPO, "configs", "ntu60_xview",
                           f"train_sgn_{name}.yaml")) as f:
        return yaml.safe_load(f)


def _x(seed, v=25):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BATCH, SEG, v * 3)).astype(np.float32)


def jax_fast(fn, *args):
    """fn(*args) as one jitted program compiled with FAST, in numpy."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _fill(shapes, seed):
    """Seeded values for a JAX variables tree of these shapes (no compiled
    init): kernels normal(1 / sqrt(fan_in)), every unit's w1 too (its init
    is zero, which would leave the G path adding nothing), BN scales
    0.5-1.5, other parameters normal(0.1); BN means normal(0.1) and
    variances 0.5-1.5, the InfoGCN prior normal(1)."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
                continue
            shape = v.shape
            if k == "mean":
                a = rng.standard_normal(shape) * 0.1
            elif k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif stats or k == "kernel":
                a = rng.standard_normal(shape) / np.sqrt(
                    max(np.prod(shape[:-1]), 1) if k == "kernel" else 1.0)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = rng.standard_normal(shape) * 0.1
            out[k] = np.asarray(a, np.float32)
        return out

    return {"params": walk(shapes["params"], False),
            "batch_stats": walk(shapes["batch_stats"], True)}


def _normalizing(apply_train, stats):
    """BN statistics that normalize: the batch statistics of a train-mode
    forward. A forward's running statistics r are affine in those it
    starts from (a BN called n times, as a shared branch's, takes n
    momentum-0.1 updates: r = 0.9^n r0 + b), so two forwards, from r0 and
    r0 + 1 (one program: vmap), give b / (1 - 0.9^n), a weighted mean of
    the n calls' batch statistics."""
    both = jax.vmap(apply_train)(jax.tree_util.tree_map(
        lambda a: jnp.stack([a, a + 1.0]), stats))

    def solve(node, r, path=()):
        if isinstance(node, dict):
            return {k: solve(v, r[k], path + (k,)) for k, v in node.items()}
        if path[-1] not in ("mean", "var"):
            return node
        kept = r[1] - r[0]
        out = (r[0] - kept * node) / (1.0 - kept)
        return out if path[-1] == "mean" else jnp.maximum(out, 1e-3)

    return solve(stats, both)


def _jax_case(model_args, seed, x_stats, x_eval, sgn_model="sgn"):
    """The JAX model, its variables with the BN statistics of a train-mode
    forward on x_stats (x_stats None: the filled ones), and its eval
    logits on x_eval: one program."""
    model = jax_registry.build_model(sgn_model, model_args)
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(seed + 1)}
    variables = _fill(jax.eval_shape(model.init, rngs,
                                     jnp.asarray(x_eval)), seed)

    def run(params, stats, xs, xe):
        def apply_train(stats):
            return model.apply(
                {"params": params, "batch_stats": stats}, xs, train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(seed + 2)}
            )[1]["batch_stats"]

        if xs is not None:
            stats = _normalizing(apply_train, stats)
        logits = model.apply({"params": params, "batch_stats": stats}, xe,
                             train=False)[0]
        return stats, logits

    stats, logits = jax_fast(run, variables["params"],
                             variables["batch_stats"],
                             None if x_stats is None else jnp.asarray(x_stats),
                             jnp.asarray(x_eval))
    return model, {"params": variables["params"], "batch_stats": stats}, \
        logits


def _port(model_args, variables):
    model = registry.build_model("sgn", model_args, device="cpu",
                                 num_frame=SEG)
    model.load_state_dict(sgn_state_dict_from_variables(variables),
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _recipe_case(name):
    args = dict(_recipe(name)["model_args"], dropout2d=0.0)
    model, variables, logits = _jax_case(args, 7, _x(1), _x(2))
    return args, model, variables, logits


@pytest.mark.parametrize("name", ["v11", "v12", "v13_gt4"])
def test_recipe_logits_match_jax(name):
    """The recipe's model at full width, built from its model_args as
    shipped (the registry takes them unchanged): eval logits within 2e-4
    of JAX's."""
    args, _, variables, want = _recipe_case(name)
    port = _port(args, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_x(2)))
    assert got.shape == (BATCH, 60)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert sum(p.numel() for p in port.parameters()) == {
        "v11": 2_620_073, "v12": 3_145_385, "v13_gt4": 3_027_373}[name]


SMALL = dict(num_class=7, c_multiplier=0.25, sgcn_dims=[16, 32, 32],
             sgcn_g_proj_dim=16, multi_t=[[3], [3], [3, 5]])


@pytest.mark.parametrize("options", [
    [dict(gcn_fpn=2, sgcn_gt_mode=2, sgcn_g_activation="sigmoid"),
     dict(gcn_fpn=3, sgcn_gt_mode=3, sgcn_g_activation="sigmoid",
          sgcn_gt_act=2, sgcn_g_proj_dim=[16, 8, 16])],
    [dict(gcn_fpn=4, sgcn_g_res_alpha=-2, semantic_class=2),
     dict(gcn_fpn=5, sgcn_g_res_alpha=0.5, multi_t=[[], [], [3]]),
     dict(multi_t_shared=2, sgcn_g_res_alpha=-1)],
    [dict(gcn_fpn=6, sgcn_gt_mode=4, sgcn_gt_g3_idx=3),
     dict(gcn_fpn=7, multi_t_shared=2, semantic_class=1)],
    [dict(gcn_fpn=9, multi_t_shared=2, multi_t=[[3], [5, 3], [3]]),
     dict(gcn_fpn=9, gcn_fpn_kernel=5, gcn_fpn_shared=1,
          sgcn_dims=[32, 32, 32], multi_t_shared=2, sgcn_gt_mode=3,
          sgcn_gt_g3_idx=1)],
], ids=["fpn2-3_gt2-3", "fpn4-5_alpha", "fpn6-7_gt4", "fpn9_shared"])
def test_small_options_match_jax(options):
    """The GCN-FPN modes 2-7 and 9 (and gcn_fpn_shared, gcn_fpn_kernel),
    GT modes 2, 3 and 4 (sigmoid g_activation, gt_act 2, g3_idx 1 and 3,
    per-unit G), res_alpha -2, -1 and 0.5, class semantics of modes 1 and
    2, shared branches (with gcn_fpn -1: named after level 1, which has
    no feature), at small widths, seeded BN statistics: eval logits
    within 2e-4 of JAX's, two or three models a case."""
    for opts in options:
        args = dict(SMALL, **opts)
        _, variables, want = _jax_case(args, 11, None, _x(4))
        port = _port(args, variables).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(_x(4)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                   err_msg=str(opts))


def _jax_grads(model, variables, x, y, mmd, monkeypatch, eps=None):
    """One JAX train-mode forward from `variables` (the recipe's label
    smoothing plus, with `mmd`, the InfoGCN MMD terms of the latent): its
    loss, the gradients, the running statistics after it, the latent and
    its prior, and each ReLU's input in call order (flax's nn.relu
    recorded); `eps` stands in for the InfoGCN head's jax.random.normal
    draw."""
    import flax.linen

    loss_fn = jlosses.build_loss("ce", model.num_class, smoothing=0.1)

    def loss_of(params):
        inputs = []
        monkeypatch.setattr(flax.linen, "relu",
                            lambda z: inputs.append(z) or jax.nn.relu(z))
        if eps is not None:
            normal = jax.random.normal
            monkeypatch.setattr(
                jax.random, "normal", lambda key, shape=(), *a, **k:
                jnp.asarray(eps) if tuple(shape) == eps.shape
                else normal(key, shape, *a, **k))
        (logits, aux), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        monkeypatch.undo()
        loss = loss_fn(logits, jnp.asarray(y))
        latent = {}
        if mmd is not None:
            latent = {"z": aux["z"], "z_prior": aux["z_prior"]}
            loss = loss + mmd(latent, jnp.asarray(y))[0]
        return loss, (inputs, mutated["batch_stats"], latent)

    # the default optimization level: at FAST, XLA's CPU backend gives
    # NaN gradients for the GCN-FPN's k=3 projections (eager JAX and the
    # default level give finite ones)
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"]))


def _port_grads(port, x, y, inputs, aux_loss=None, eps=None):
    """The port's forward with JAX's ReLU masks (and eps) replayed, the
    loss and its backward: (loss, metrics, ReLU probe)."""
    relus = types.SimpleNamespace(
        inputs=[torch.from_numpy(np.array(z)) for z in inputs])
    relus.masks = [z > 0 for z in relus.inputs]
    probe = ReluProbe(ref=relus)
    noise = NoiseProbe(ref=types.SimpleNamespace(
        draws=[] if eps is None else [torch.from_numpy(eps)]))
    with relu_probe(probe), noise_probe(noise):
        out = port(torch.from_numpy(x), **(
            {"return_aux": True} if aux_loss is not None else {}))
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = tlosses.build_loss("ce", logits.shape[-1], smoothing=0.1)(
            logits, torch.from_numpy(y))
        metrics = {}
        if aux_loss is not None:
            extra, metrics = aux_loss(aux, torch.from_numpy(y))
            loss = loss + extra
    loss.backward()
    assert len(probe.masks) == len(relus.masks)
    assert probe.input_diff <= 1e-3, probe.input_diff
    assert len(noise.draws) == (eps is not None)
    return loss, metrics, probe


def _check_grads(port, jax_grads, stats, sd_map):
    """Every gradient within 2e-4 of its tensor's scale (the unused G
    `alpha`: none here, zero in JAX) and every BN running statistic after
    the step within 1e-5 of its scale, both through the map."""
    want = sd_map({"params": jax_grads, "batch_stats": stats})
    grads = {}
    for name, p in port.named_parameters():
        if name.endswith(".alpha"):
            assert p.grad is None and not np.any(want[name].numpy())
        else:
            grads[name] = p.grad
    rows = grad_errors(grads, {k: want[k] for k in grads}, 2e-4)
    assert rows[0][0] <= 1.0, rows[:3]
    for name, buf in port.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                buf.numpy(), want[name].numpy(), rtol=0,
                atol=1e-5 * float(want[name].abs().max()), err_msg=name)


def _cfg(recipe, model_args):
    return types.SimpleNamespace(
        mmd_lambda1=recipe["mmd_lambda1"], mmd_lambda2=recipe["mmd_lambda2"],
        fsim_mode=0, fsim_alpha=0.0, model_args=model_args,
        seed=recipe["seed"])


MMD_METRICS = ("mmd", "l2_z_mean", "cos_z", "dist_z", "cos_z_prior",
               "dist_z_prior")


def test_v12_step_with_mmd_matches_jax(monkeypatch):
    """v12 at small width (c4 128, 7 classes), dropout 0, the recipe's
    MMD lambdas: one train-mode forward with the JAX eps replayed (the
    head's draw), label smoothing plus the MMD loss of the JAX trainer's
    closure: the loss 1e-4 relative, the six metrics 1e-5, every gradient
    and the running statistics; the shared temporal branches (one a
    kernel, named after level 1) take three calls a forward each, and
    their statistics chain through them as in JAX."""
    recipe = _recipe("v12")
    args = dict(recipe["model_args"], dropout2d=0.0, num_class=7,
                c_multiplier=0.25, sgcn_dims=[16, 32, 32],
                sgcn_g_proj_dim=16)
    model = jax_registry.build_model("sgn", args)
    x, y = _x(8), np.array([0, 3, 3, 5])
    variables = _fill(jax.eval_shape(model.init, {
        "params": jax.random.PRNGKey(0),
        "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x)), 9)
    eps = np.random.default_rng(10).standard_normal((BATCH, 128)).astype(
        np.float32)
    jaux = JaxTrainer._build_aux_loss(types.SimpleNamespace(
        cfg=_cfg(recipe, args)))

    def mmd(latent, y):  # the closure's loss; its metrics come after
        terms = jlosses.mmd_loss(latent["z"], latent["z_prior"], y, 7)
        return (recipe["mmd_lambda2"] * terms[0]
                + recipe["mmd_lambda1"] * terms[1],)

    (want_loss, (inputs, stats, latent)), grads = _jax_grads(
        model, variables, x, y, mmd, monkeypatch, eps)
    want_m = jaux(latent, jnp.asarray(y))[1]
    port = _port(args, variables).train()
    names = [n for n, _ in port.named_children() if n.startswith("tem_")]
    assert names == ["tem_mlp_1_1_k3", "tem_mlp_1_2_k5", "tem_mlp_1_3_k7"]
    aux_loss = build_aux_loss(_cfg(recipe, args), port)
    loss, metrics, _ = _port_grads(port, x, y, inputs, aux_loss, eps)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    for k in MMD_METRICS:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    _check_grads(port, grads, stats, sgn_state_dict_from_variables)


def test_mmd_loss_and_metrics_match_jax_closure():
    """`mmd_loss` and the six metrics of the port's `build_aux_loss`
    against the JAX trainer's `_build_aux_loss` closure (called on a stub
    holding the config) on seeded z, prior and labels with absent and
    repeated classes, 1e-5 relative: with a prior as wide as z, and with
    a narrower one (tiled). The MMD loss without the InfoGCN head raises
    naming the known difference (Queue 3); gcn_fpn_output_merge 2 with
    the head raises ValueError, as in JAX."""
    recipe = _recipe("v12")
    args = dict(recipe["model_args"], num_class=9)
    cfg = _cfg(recipe, args)
    jaux = JaxTrainer._build_aux_loss(types.SimpleNamespace(cfg=cfg))
    rng = np.random.default_rng(12)
    z = rng.standard_normal((6, 32)).astype(np.float32)
    y = np.array([0, 2, 2, 5, 8, 0])
    for width in (32, 12):
        prior = rng.standard_normal((9, width)).astype(np.float32)
        want_loss, want = jaux({"z": jnp.asarray(z),
                                "z_prior": jnp.asarray(prior)},
                               jnp.asarray(y))
        model = types.SimpleNamespace(z_prior=torch.from_numpy(prior))
        got_loss, got = build_aux_loss(cfg, model)(
            {"z": torch.from_numpy(z), "z_prior": torch.from_numpy(prior)},
            torch.from_numpy(y))
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
        assert sorted(got) == sorted(want) == sorted(MMD_METRICS)
        for k in MMD_METRICS:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=f"{width} {k}")
    mmd, l2z = tlosses.mmd_loss(torch.from_numpy(z), torch.from_numpy(
        prior[:, :1].repeat(32, 1)), torch.from_numpy(y), 9)
    want = jlosses.mmd_loss(jnp.asarray(z), jnp.asarray(
        prior[:, :1].repeat(32, 1)), jnp.asarray(y), 9)
    np.testing.assert_allclose([float(mmd), float(l2z)],
                               np.asarray(want, np.float64), rtol=1e-5)
    with pytest.raises(NotImplementedError, match=r"InfoGCN head.*Queue 3"):
        build_aux_loss(cfg, torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="InfoGCN latent head"):
        registry.build_model("sgn", dict(args, gcn_fpn_output_merge=2),
                             device="cpu")


def test_v12_loads_strict_and_z_prior_init(tmp_path):
    """The port's map of v12 holds every key of the JAX export with its
    values, and also the GCN-FPN projections, fc_mu, fc_logvar and
    z_prior that the JAX export leaves out; a JAX npz and a reference-named
    `.pt` load strict. The port's own prior: z_prior z_prior^T = gain^2 I
    (the orthogonal init at gain 3; the values cannot match JAX's), a
    buffer and no parameter."""
    from agcn_tpu.train.checkpoint import save_checkpoint
    from agcn_tpu_torch.train.checkpoint import load_checkpoint

    args, _, variables, _ = _recipe_case("v12")
    got = sgn_state_dict_from_variables(variables)
    want = torch_export.sgn_state_dict_from_variables(variables)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    extra = sorted(set(got) - set(want))
    assert extra == sorted(
        [f"fpn_proj{i}.block.conv.conv.{p}" for i in (1, 2, 3)
         for p in ("bias", "weight")]
        + [f"{fc}.{p}" for fc in ("fc_logvar", "fc_mu")
           for p in ("bias", "weight")] + ["z_prior"])
    torch.save(got, tmp_path / "sgn_v12.pt")
    save_checkpoint(str(tmp_path / "jax"), variables, use_orbax=False)
    for path in ("sgn_v12.pt", "jax"):
        sd = load_checkpoint(str(tmp_path / path), "model.sgn_v12.SGN",
                             args)["model"]
        registry.build_model("sgn", args, device="cpu").load_state_dict(
            sd, strict=True)
    port = registry.build_model("sgn", args, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    prior = port.z_prior.double()
    assert tuple(prior.shape) == (60, 512)
    np.testing.assert_allclose((prior @ prior.T).numpy(),
                               9.0 * np.eye(60), atol=1e-4)
    assert "z_prior" in dict(port.named_buffers())
    assert "z_prior" not in dict(port.named_parameters())


def test_sgn_original_matches_jax(tmp_path, monkeypatch):
    """`sgn_original` under its four names: the JAX variables through the
    port's map (equal to the JAX export: names and values) load strict,
    as do a reference `.pt` and a JAX npz; eval logits within 2e-4, G 1e-5;
    one train-mode step at dropout 0 with JAX's ReLU masks replayed: the
    loss 1e-4 relative, every gradient and running statistic."""
    from agcn_tpu.train.checkpoint import save_checkpoint
    from agcn_tpu_torch.train.checkpoint import load_checkpoint

    args = dict(num_class=11, dropout=0.0)
    model, variables, want = _jax_case(args, 5, _x(5), _x(6),
                                       sgn_model="sgn_original")
    sd = sgn_original_state_dict_from_variables(variables)
    export = torch_export.sgn_original_state_dict_from_variables(variables)
    assert sorted(sd) == sorted(export)
    for k, w in export.items():
        np.testing.assert_array_equal(sd[k].numpy(), w, err_msg=k)
    torch.save(sd, tmp_path / "sgn.pt")
    save_checkpoint(str(tmp_path / "jax"), variables, use_orbax=False)
    for name, path in (("sgn_original", "sgn.pt"), ("model.sgn.SGN", "jax"),
                       ("model.architecture.sgn.sgn.SGN", "sgn.pt"),
                       ("model.architecture.sgn.archiv.sgn.SGN", "jax")):
        port = registry.build_model(name, args, device="cpu", num_frame=SEG)
        assert isinstance(port, SGNOriginal)
        port.load_state_dict(load_checkpoint(str(tmp_path / path), name,
                                             args)["model"], strict=True)
    with torch.no_grad():
        got, g = port.eval()(torch.from_numpy(_x(6)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    want_g = jax_fast(lambda v, x: model.apply(v, x)[1], variables,
                      jnp.asarray(_x(6)))
    np.testing.assert_allclose(g.numpy(), want_g, atol=1e-5)

    x, y = _x(7), np.array([1, 4, 4, 10])
    (want_loss, (inputs, stats, _)), grads = _jax_grads(
        model, variables, x, y, None, monkeypatch)
    loss, _, probe = _port_grads(port.train(), x, y, inputs)
    assert len(probe.masks) == 13
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _check_grads(port, grads, stats, sgn_original_state_dict_from_variables)
