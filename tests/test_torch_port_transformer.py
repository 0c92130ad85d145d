"""The port's AAGCN transformer (agcn_tpu_torch/models/aagcn_transformer.py)
and its attention layers (agcn_tpu_torch/ops/attention.py) against the
JAX package on the CPU, at small sizes: backbone 16 channels, T <= 16,
batch 2, 1-2 encoder layers, 4 heads.

Weights move JAX -> port through the port's
`aagcn_transformer_state_dict_from_variables` with a strict load (the
layers: the same names through a state dict the test writes).

Tolerances: the layers 1e-5 (fp32 sums of another order over <= 64
terms); the model's fp32 logits and attention maps 2e-4 (the AAGCN bar,
tests/test_aagcn.py), one train step's gradients 2e-4 with dropout 0;
bf16 logits 2% of the logit scale (~3 significant digits per layer); the
served probabilities 1e-4. The trainer runs are in
tests/test_torch_port_transformer_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.infer.serving import BatchedStreamServer as JaxServer
from agcn_tpu.models.aagcn_transformer import \
    AAGCNTransformer as JaxTransformer
from agcn_tpu.ops import attention as jatt
from agcn_tpu.ops import initializers as jinit
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train import optim as joptim
from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu_torch.infer import BatchedStreamServer
from agcn_tpu_torch.models import AAGCNTransformer, build_model
from agcn_tpu_torch.ops import attention as tatt
from agcn_tpu_torch.ops import initializers as tinit
from agcn_tpu_torch.train import checkpoint as tckpt
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.train import optim as toptim
from agcn_tpu_torch.utils import weights
from agcn_tpu_torch.utils.weights import (
    aagcn_transformer_state_dict_from_variables, model_state_dict)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7
ADJ = jax_build_adjacency("ntu_rgb_d")
SMALL = dict(backbone_channels=16, num_layers=2, num_heads=4,
             dim_feedforward=32, num_class=NUM_CLASS)
# the frame tokens SMALL's 'dual' model makes of _x(): (N*M, 1 + T, C); the
# layer tests take its shapes, so JAX compiles its ops once for both
TOKENS_T = (4, 13, 16)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _x(seed=3, n=2, t=12):
    return _np(seed, n, 3, t, 25, 2)


def _randomize(variables, seed=0, condition=False):
    """Seeded BN statistics and affines, PA about the graph, alpha live;
    LayerNorms away from (1, 0); CLS tokens and position tables at
    normal(0.5), as trained ones grow (at their normal(0.02) init, a CLS
    token's pre-norm LayerNorm scales its gradient by ~50). `condition`:
    BN shifts 0.5-0.7 over scales 0.1-0.2, which keep ReLU inputs away
    from the kink for gradient parity."""
    rng = np.random.default_rng(seed)

    def walk(node, stats, path):
        is_bn = "scale" in node and "kernel" not in node
        out = {}
        for k, v in node.items():
            v = np.asarray(v, np.float32) if not isinstance(v, dict) else v
            if isinstance(v, dict):
                out[k] = walk(v, stats, path + (k,))
            elif k == "PA":
                out[k] = v + rng.standard_normal(v.shape).astype(
                    np.float32) * 0.05
            elif k == "alpha":
                out[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
            elif k.startswith("cls_token") or k == "embedding":
                out[k] = rng.standard_normal(v.shape).astype(np.float32) * .5
            elif stats and k == "mean":
                out[k] = rng.standard_normal(v.shape).astype(np.float32) * .1
            elif stats and k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif is_bn and k == "scale":
                out[k] = rng.uniform(*((0.1, 0.2) if condition and not any(
                    p.startswith("norm") for p in path) else (0.5, 1.5)),
                    v.shape).astype(np.float32)
            elif is_bn and k == "bias":
                out[k] = (rng.uniform(0.5, 0.7, v.shape) if condition
                          and not any(p.startswith("norm") for p in path)
                          else v + rng.standard_normal(v.shape) * 0.1
                          ).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"params": walk(variables["params"], False, ()),
            "batch_stats": walk(variables["batch_stats"], True, ())}


def _variables(t=12, seed=0, condition=False, **kw):
    """Seeded JAX variables, made once per configuration in this process
    (the tests only read them)."""
    return _made_variables(t, seed, condition, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _made_variables(t, seed, condition, kw):
    model = JaxTransformer(adj=ADJ, **dict(kw))
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(_x(t=t)),
                           train=False)
    return _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      seed, condition)


def _jax_apply(variables, x, **kw):
    """The JAX model's eval forward (op by op: at these sizes compiling
    it costs more than it saves)."""
    return JaxTransformer(adj=ADJ, **kw).apply(variables, jnp.asarray(x),
                                               train=False)


def _port(variables, t=12, **kw):
    model = AAGCNTransformer(adj=ADJ, device="cpu", num_frame=t, **kw)
    model.load_state_dict(
        aagcn_transformer_state_dict_from_variables(variables), strict=True)
    return model


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# -- layers --------------------------------------------------------------


def _layer_state(variables):
    """A flax layer's params in the port's names (the encoder map)."""
    out = {}
    weights._encoder_out(out, "e", {"layer1": variables["params"]})
    return {k[len("e.layer1."):]: torch.from_numpy(np.array(v))
            for k, v in out.items()}


@pytest.mark.parametrize("pre_norm,activation", [(True, "relu"),
                                                 (False, "relu"),
                                                 (True, "gelu")])
def test_encoder_layer_matches_jax(pre_norm, activation):
    x = _np(0, *TOKENS_T)
    jl = jatt.TransformerEncoderLayer(4, 32, dropout=0.0,
                                      activation=activation,
                                      pre_norm=pre_norm)
    v = jax.tree_util.tree_map(np.asarray, jl.init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    for name in ("norm1", "norm2"):  # LayerNorms away from (1, 0)
        v["params"][name] = {"scale": _np(2, 16, scale=0.3) + 1.0,
                             "bias": _np(3, 16, scale=0.3)}
    want, wattn = jl.apply(v, jnp.asarray(x))
    tl = tatt.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                      activation=activation,
                                      pre_norm=pre_norm)
    tl.load_state_dict(_layer_state(v), strict=True)
    got, attn = tl.eval()(torch.from_numpy(x))
    _close(got.detach(), want, 1e-5)
    _close(attn.detach(), wattn, 1e-5)
    assert attn.shape == (4, 4, 13, 13)


@pytest.mark.parametrize("pos_enc", ["abs", "cos", None])
def test_encoder_matches_jax(pos_enc):
    x = _np(4, *TOKENS_T)
    je = jatt.TransformerEncoder(num_layers=2, num_heads=4,
                                 dim_feedforward=32, dropout=0.0,
                                 pre_norm=True, pos_enc=pos_enc, max_len=14)
    v = jax.tree_util.tree_map(np.asarray, je.init(jax.random.PRNGKey(2),
                                                   jnp.asarray(x)))
    want, wattn = je.apply(v, jnp.asarray(x))
    te = tatt.TransformerEncoder(16, num_layers=2, num_heads=4,
                                 dim_feedforward=32, dropout=0.0,
                                 pre_norm=True, pos_enc=pos_enc, max_len=14)
    out = {}
    weights._encoder_out(out, "e", v["params"])
    te.load_state_dict({k[2:]: torch.from_numpy(np.array(a))
                        for k, a in out.items()}, strict=True)
    got, attn = te.eval()(torch.from_numpy(x))
    _close(got.detach(), want, 1e-5)
    assert len(attn) == 2
    for a, w in zip(attn, wattn):
        _close(a.detach(), w, 1e-5)
    if pos_enc:  # more tokens than the table has rows
        with pytest.raises(ValueError, match="rows"):
            te(torch.zeros(1, 15, 16))


def test_cross_transformer_matches_jax():
    a, b = _np(5, *TOKENS_T), _np(6, 4, 26, 16)
    jc = jatt.CrossTransformer(num_heads=4, dim_head=64, depth=2)
    v = jax.tree_util.tree_map(np.asarray, jc.init(
        jax.random.PRNGKey(3), jnp.asarray(a), jnp.asarray(b)))
    wa, wb = jc.apply(v, jnp.asarray(a), jnp.asarray(b))
    tc = tatt.CrossTransformer(16, num_heads=4, dim_head=64, depth=2)
    out = {}
    weights._cross_fusion_out(out, "c", v["params"])
    tc.load_state_dict({k[2:]: torch.from_numpy(np.array(a))
                        for k, a in out.items()}, strict=True)
    ga, gb = tc(torch.from_numpy(a), torch.from_numpy(b))
    _close(ga.detach(), wa, 1e-5)
    _close(gb.detach(), wb, 1e-5)
    np.testing.assert_array_equal(ga[:, 1:].detach().numpy(), a[:, 1:])


def test_initializers_match_flax_statistics():
    """lecun_normal (flax Dense's default: truncated at 2 std), normal
    (0.02) and xavier_normal, each against the JAX package's draw of the
    same shape by standard deviation (5%) and range."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    w = tinit.lecun_normal(torch.empty(512, 256), g)
    jw = np.asarray(jax.nn.initializers.lecun_normal()(key, (256, 512)))
    assert abs(w.std().item() / jw.std() - 1) < 0.05
    assert abs(w.std().item() * 16 - 1) < 0.05  # variance 1 / fan_in
    bound = 2 * np.sqrt(1 / 256) / .87962566103423978
    assert w.abs().max().item() <= bound and np.abs(jw).max() <= bound
    n = tinit.normal(0.02)(torch.empty(300, 64), g)
    jn = np.asarray(jax.nn.initializers.normal(0.02)(key, (300, 64)))
    assert abs(n.std().item() / jn.std() - 1) < 0.05
    x = tinit.xavier_normal(torch.empty(3 * 64, 64), g)
    jx = np.asarray(jinit.xavier_normal(key, (64, 3 * 64)))
    assert abs(x.std().item() / jx.std() - 1) < 0.05
    # the model's CLS tokens and position tables, and its zero biases
    m = AAGCNTransformer(adj=ADJ, device="cpu", mode="dual", num_frame=300,
                         generator=torch.Generator().manual_seed(1))
    table = m.temporal_encoder.pos_enc.embedding
    assert tuple(table.shape) == (302, 64)
    assert tuple(m.spatial_encoder.pos_enc.embedding.shape) == (27, 64)
    assert abs(table.std().item() / 0.02 - 1) < 0.05
    assert torch.all(m.temporal_encoder.layer1.linear1.bias == 0)


def test_unported_options_raise():
    """No option of the attention raises any more: the boolean mask,
    ported with the SGN transformer (held against JAX in
    tests/test_torch_port_sgn_transformer.py), and the AAGCN versions'
    options, ported with them, build and run (held against JAX in
    tests/test_torch_port_aagcn_versions.py)."""
    assert tatt.MultiheadAttention(8, 2, rel_pos_len=4).pos_emb is not None
    layer = tatt.TransformerEncoderLayer(8, 2, 16, bias=False)
    assert layer.linear1.bias is None and layer.norm1.bias is None
    assert tatt.MultiheadAttention(8, 2, bias=False).in_proj_bias is None
    mha = tatt.MultiheadAttention(8, 2)
    mha.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.zeros(1, 3, 8)
    out, attn = mha(x, mask=torch.tensor([[True, False, False]] * 3))
    assert out.shape == x.shape
    assert torch.equal(attn[..., 0], torch.ones(1, 2, 3))
    for kw in ("additive_mask", "alpha", "global_attn"):
        out, _ = mha(x, **{kw: torch.zeros(3, 3)})
        assert out.shape == x.shape


# -- the model -------------------------------------------------------------

# the cases share shapes where they can (the dual ones with one another
# and with the tests below), so JAX compiles fewer of its ops
_MODES = [dict(mode="temporal", model_layers=101),
          dict(mode="spatial", model_layers=102),
          dict(mode="dual", model_layers=101),
          dict(mode="dual", model_layers=102, cross_fusion=True),
          dict(mode="dual", model_layers=101, use_cls_token=False,
               pos_enc="cos", pre_norm=False),
          dict(mode="spatial", model_layers=101, pos_enc="none",
               use_cls_token=False)]
_IDS = ["temporal", "spatial", "dual", "dual_cross", "dual_nocls_cos_post",
        "spatial_nopos_nocls"]


@pytest.mark.parametrize("kw", _MODES, ids=_IDS)
def test_aagcn_transformer_matches_jax(kw):
    kw = dict(SMALL, **kw)
    variables = _variables(**kw)
    x = _x(seed=5)
    want, aux = _jax_apply(variables, x, **kw)
    with torch.no_grad():
        got, attn = _port(variables, **kw).eval()(torch.from_numpy(x),
                                                   return_attention=True)
    assert got.shape == (2, NUM_CLASS) and got.dtype == torch.float32
    _close(got, want, 2e-4)
    flat_w = jax.tree_util.tree_leaves(aux["attn"])
    flat_g = jax.tree_util.tree_leaves(
        attn, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert isinstance(attn, dict) == (kw["mode"] == "dual")
    assert len(flat_g) == len(flat_w) == (4 if kw["mode"] == "dual" else 2)
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape
        _close(g, w, 2e-4)


def test_aagcn_transformer_bf16_close_to_jax_bf16():
    kw = dict(SMALL, mode="dual", model_layers=102, cross_fusion=True)
    variables = _variables(**kw)
    x = _x(seed=6)
    want, _ = _jax_apply(variables, x, dtype=jnp.bfloat16, **kw)
    want = np.asarray(want, np.float32)
    with torch.no_grad():
        got = _port(variables, dtype=torch.bfloat16, **kw).eval()(
            torch.from_numpy(x))
    assert got.dtype == torch.float32  # the heads run in fp32
    _close(got, want, 2e-2 * np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(mode="dual", cross_fusion=True),
                                dict(mode="temporal")],
                         ids=["dual_cross", "temporal"])
def test_one_train_step_grads_match_jax(kw):
    """Train mode (BN batch statistics), dropout 0: the loss and every
    parameter's gradient."""
    kw = dict(SMALL, model_layers=102, dropout=0.0, **kw)
    variables = _variables(condition=True, **kw)
    x, y = _x(seed=7), np.array([1, 4])
    jmodel = JaxTransformer(adj=ADJ, **kw)

    def loss_of(params):
        (logits, _), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy(logits, jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(
        variables["params"])
    want = aagcn_transformer_state_dict_from_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]})
    model = _port(variables, **kw).train()
    loss = tlosses.cross_entropy(model(torch.from_numpy(x)),
                                 torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4)
    names = 0
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 2e-4)
        names += 1
    assert names > 50


def test_state_dict_is_the_reference_map(tmp_path):
    kw = dict(SMALL, mode="dual", model_layers=102, cross_fusion=True)
    variables = _variables(**kw)
    sd = _port(variables, **kw).state_dict()
    assert set(sd) == set(aagcn_transformer_state_dict_from_variables(
        variables))
    for key, shape in [("temporal_encoder.layer1.self_attn.in_proj_weight",
                        (48, 16)),
                       ("temporal_encoder.layer2.self_attn.out_proj.weight",
                        (16, 16)),
                       ("temporal_encoder.layer1.linear1.weight", (32, 16)),
                       ("spatial_encoder.layer2.norm2.bias", (16,)),
                       ("temporal_encoder.pos_enc.embedding", (14, 16)),
                       ("spatial_encoder.pos_enc.embedding", (27, 16)),
                       ("cls_token_t", (1, 1, 16)),
                       ("cross_fusion.a_attends_b1.to_q.weight", (256, 16)),
                       ("cross_fusion.norm_b1.weight", (16,)),
                       ("l2.gcn1.agcn.PA", (3, 25, 25)),
                       ("data_bn.running_mean", (150,)),
                       ("fc.weight", (NUM_CLASS, 32))]:
        assert tuple(sd[key].shape) == shape, key
    # the registry, the reference aliases, and checkpoint dispatch
    args = dict(kw, graph="ntu_rgb_d")
    for name in ("aagcn_transformer", "model.aagcn_v37.Model",
                 "model.architecture.aagcn.aagcn_v37.Model"):
        built = build_model(name, dict(args, drop_out=0.5), device="cpu",
                            num_frame=12)
        assert isinstance(built, AAGCNTransformer)
        assert built.fc_drop.p == 0.5
    got = model_state_dict(variables, "model.aagcn_v37.Model", args)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    # weights made for another T: refused, naming both
    save_checkpoint(str(tmp_path / "ckpt"), variables, use_orbax=False)
    state = tckpt.load_checkpoint(str(tmp_path / "ckpt"),
                                  "aagcn_transformer", args)["model"]
    model = build_model("aagcn_transformer", args, device="cpu",
                        num_frame=20)
    with pytest.raises(ValueError, match=r"T = 12 .*T = 20"):
        model.load_state_dict(state, strict=True)


def test_llrd_scales_match_jax_on_the_model():
    """agcn_tpu's llrd_scale_tree over the JAX tree against the port's
    llrd_scales over its parameter names, leaf by leaf through the weight
    map: both encoders' layerN share a multiplier, the deepest keeps the
    base LR, and nothing else (blocks l1, l2, cross_fusion, CLS tokens,
    linear1) takes one."""
    kw = dict(SMALL, mode="dual", model_layers=102, cross_fusion=True)
    variables = _variables(**kw)
    mults = joptim.llrd_scale_tree(variables["params"], 0.8)
    filled = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32),
        variables["params"], mults)
    want = aagcn_transformer_state_dict_from_variables(
        {"params": filled, "batch_stats": variables["batch_stats"]})
    names, _ = zip(*_port(variables, **kw).named_parameters())
    got = toptim.llrd_scales(names, 0.8)
    for name, scale in zip(names, got):
        assert torch.all(want[name] == np.float32(scale)), name
    assert {n.split(".")[1] for n, s in zip(names, got)
            if s != 1.0} == {"layer1"}


def test_dropout_draws_from_the_model_generator():
    kw = dict(SMALL, mode="dual", model_layers=101, cross_fusion=True,
              drop_out=0.5, dropout=0.2)
    variables = _variables(**kw)
    x = torch.from_numpy(_x(seed=8))
    want, _ = _jax_apply(variables, x.numpy(), **kw)
    outs = []
    for _ in range(2):
        model = _port(variables, generator=torch.Generator().manual_seed(4),
                      **kw)
        dropouts = [m for m in model.modules()
                    if isinstance(m, tatt.Dropout)]
        assert len(dropouts) == 1 + 2 * 2 * 4  # fc_drop, 4 a layer
        assert all(m.generator is model.dropout_generator
                   for m in dropouts)
        with torch.no_grad():
            _close(model.eval()(x), want, 2e-4)  # no dropout at eval
            state = torch.get_rng_state()
            outs.append([model.train()(x) for _ in range(2)])
            assert torch.equal(state, torch.get_rng_state())
    assert torch.equal(outs[0][0], outs[1][0])  # seeded
    assert not torch.equal(outs[0][0], outs[0][1])  # fresh masks


# -- serving -------------------------------------------------------------


def _frames(seed, n_frames=40):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 1, 25, 3)).astype(np.float32) * 0.2
            for _ in range(n_frames)]


def test_port_server_answers_as_jax_server():
    """Same frames, same weights: the same labels and probabilities within
    1e-4; the port's model sized for the server's window."""
    kw = dict(SMALL, mode="dual", model_layers=102, cross_fusion=True)
    t = 12
    variables = _variables(t=t, **kw)
    jmodel = JaxTransformer(adj=ADJ, **kw)
    tmodel = _port(variables, t=t, **kw).eval()
    kwargs = dict(max_seq_length=t, moving_avg=2,
                  allowed_classes=[0, 2, 3, 5])
    jserver = JaxServer(jmodel, variables, max_streams=3, kind="dense",
                        **kwargs)
    tserver = BatchedStreamServer(tmodel, max_streams=3, **kwargs)
    for sid in range(3):
        assert jserver.add_stream() == tserver.add_stream() == sid
        for f in _frames(sid + 20, n_frames=24):
            jserver.append_frame(sid, f)
            tserver.append_frame(sid, f)
    want, got = jserver.predict(), tserver.predict()
    assert set(want) == set(got) == {0, 1, 2}
    for sid in want:
        assert got[sid][0] == want[sid][0]
        np.testing.assert_allclose(got[sid][1], want[sid][1], atol=1e-4)


def test_cli_serves_a_transformer_config_on_cpu(tmp_path, capsys):
    """python -m agcn_tpu_torch.infer --serve 2 on a small transformer
    config, weights from a trainer checkpoint; the model is built for
    --max-frame."""
    from agcn_tpu_torch.infer.cli import main as cli_main

    rec = tmp_path / "rec"
    rec.mkdir()
    for i in range(2):
        np.save(rec / f"cam{i}.npy", _np(i, 3, 16, 25, 2))
    args = dict(SMALL, graph="ntu_rgb_d", mode="dual", model_layers=101,
                cross_fusion=True)
    model = build_model("aagcn_transformer", args, device="cpu",
                        num_frame=16)
    tckpt.save_checkpoint(str(tmp_path / "w"), model, {}, step=1, epoch=1,
                          steps_per_epoch=1)
    (tmp_path / "serve.yaml").write_text(yaml.safe_dump(
        {"model": "model.aagcn_v37.Model", "model_args": args}))
    cli_main(["--config", str(tmp_path / "serve.yaml"),
              "--weights", str(tmp_path / "w.pt"), "--input", str(rec),
              "--serve", "2", "--interval", "8", "--max-frame", "16",
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[cam") for ln in lines) == 2 * 2
