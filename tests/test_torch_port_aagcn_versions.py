"""The port's AAGCN versions (agcn_tpu_torch/models/aagcn_versions.py) and
their attention options (agcn_tpu_torch/ops/attention.py) against the
JAX package on the CPU, at small sizes: one 24-channel backbone unit
(model_layers 101, kernel 3 with stride 3, no pad), T = 12 (T' = 4),
batch 2, two transformer layers.

Every version and mode that tests/test_aagcn_versions.py parametrises is
a case of `test_version_logits_match_jax`: the JAX model's variables
(shapes from `jax.eval_shape` of its init, values seeded: every
parameter away from its init so that each path counts) go through the
port's `aagcn_v*_state_dict_from_variables` with a strict load, and back
through JAX's `torch_import.aagcn_v*_variables_from_torch`. Each JAX
forward is one jitted program compiled at XLA's lowest backend
optimization level (`jax_fast`), which compiles in a fraction of the
time of the eager op-by-op forward. The training runs are in
tests/test_torch_port_aagcn_versions_train.py.

Tolerances: fp32 eval logits 2e-4 (the AAGCN bar, tests/test_aagcn.py);
the round trip bit for bit; the layers 1e-5 (fp32 sums of another order
over <= 96 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.models import aagcn_versions as jv
from agcn_tpu.models import registry as jax_registry
from agcn_tpu.ops import attention as jatt
from agcn_tpu.utils import torch_import
from agcn_tpu_torch.models import aagcn_versions as tv
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.ops import attention as tatt
from agcn_tpu_torch.utils import weights
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7
ADJ = jax_build_adjacency("ntu_rgb_d")
T = 12
BASE = dict(model_layers=101, kernel_size=3, pad=False, num_class=NUM_CLASS)
# the versions' widths, one 24-channel backbone for all (24 = 3 heads x 8
# for v24's per-subset heads); v34's rel modes need the CLS slot: t_length
# = T' + 1
WIDTHS = {
    "v17": dict(trans_model_dim=24, trans_ffn_dim=16, trans_dropout=0.0),
    "v24": dict(s_num_heads=3, s_model_dim=24, s_ffn_dim=96, dropout=0.0,
                num_layers=2, pos_enc="cossin"),
    "v30": dict(backbone_dim=24, t_model_dim=24, t_ffn_dim=400,
                num_layers=2, pos_enc="cossin"),
    "v31": dict(backbone_dim=24, t_model_dim=24, t_ffn_dim=16,
                s_model_dim=24, s_ffn_dim=16, dropout=0.0, num_layers=2,
                pos_enc="cossin"),
    "v34": dict(backbone_dim=24, trans_len=4, t_model_dim=24, t_ffn_dim=16,
                t_length=5, s_model_dim=24, s_ffn_dim=16, s_length=25,
                dropout=0.0, num_layers=2, pos_enc="cossin"),
}
WIDTHS["v32"] = WIDTHS["v31"]
JAX_CLASSES = {"v17": jv.AAGCNv17, "v24": jv.AAGCNv24, "v30": jv.AAGCNv30,
               "v31": jv.AAGCNv31, "v32": jv.AAGCNv31, "v34": jv.AAGCNv34}
IMPORTS = {"v17": torch_import.aagcn_v17_variables_from_torch,
           "v24": torch_import.aagcn_v24_variables_from_torch,
           "v30": torch_import.aagcn_v30_variables_from_torch,
           "v31": torch_import.aagcn_v31_variables_from_torch,
           "v32": torch_import.aagcn_v31_variables_from_torch,
           "v34": torch_import.aagcn_v34_variables_from_torch}

# tests/test_aagcn_versions.py:35-240, each mode at the widths above
CASES = [
    ("v17", dict(pos_enc="True", classifier_type="CLS", trans_num_layers=2)),
    ("v17", dict(pos_enc="cossin", classifier_type="GAP",
                 trans_num_layers=1)),
    ("v17", dict(pos_enc="cossin", classifier_type="CLS", trans_num_layers=2,
                 attn_masking="backward")),
    ("v17", dict(pos_enc="True", classifier_type="CLS", trans_num_layers=1,
                 trans_prenorm=True)),
    ("v30", dict(gcn_trans_unit="v2")),
    ("v30", dict(gcn_trans_unit="v3")),
    ("v31", dict(trans_seq="s-t")),
    ("v31", dict(trans_seq="t-s")),
    ("v31", dict(trans_seq="sa-t", add_A=True)),
    ("v31", dict(trans_seq="sa-t-res", add_A=True, add_Aa=True,
                 res_dropout=0.0, multi_trans_dropout=0.0)),
    ("v32", dict(trans_seq="sa-t", add_A=True)),
    ("v32", dict(trans_seq="sa-t-attn-a", add_A=True)),
    ("v32", dict(trans_seq="sa-t-res", add_A=True, res_dropout=0.0,
                 multi_trans_dropout=0.0)),
    ("v32", dict(trans_seq="sa-t-res-attn-a", add_A=True, res_dropout=0.0,
                 multi_trans_dropout=0.0)),
    ("v24", dict(add_A="False", classifier_type="CLS")),
    ("v24", dict(add_A="single", classifier_type="CLS")),
    ("v24", dict(add_A="triple", classifier_type="CLS")),
    ("v24", dict(add_A="single", classifier_type="CLS_MASK")),
    ("v34", dict(trans_seq="s-t", classifier_type="GAP")),
    ("v34", dict(trans_seq="t-s", classifier_type="CLS-POOL")),
    ("v34", dict(trans_seq="s-t-v2", classifier_type="CLS")),
    ("v34", dict(trans_seq="sa-t-v2", add_A=True, add_Aa="True",
                 classifier_type="CLS")),
    ("v34", dict(trans_seq="sa-t-res-v3", add_A=True, add_Aa="one",
                 res_dropout=0.0, multi_trans_dropout=0.0,
                 classifier_type="CLS")),
]


def _x(seed=1, n=2, t=T, empty_from=None):
    x = np.random.default_rng(seed).standard_normal(
        (n, 3, t, 25, 2)).astype(np.float32)
    if empty_from is not None:
        x[:, :, empty_from:] = 0.0
    return x


def fill(shapes, seed=0):
    """Seeded values for a JAX variables tree of these shapes: kernels
    normal(1 / sqrt(fan_in)), BN and LayerNorm scales 0.5-1.5, statistics
    that normalize, alphas 0.2-0.5, PA 0-0.5, CLS tokens, position and
    relative-position tables normal(0.5), biases normal(0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
                continue
            shape = v.shape
            if stats:
                a = (rng.standard_normal(shape) * 0.1 if k == "mean"
                     else rng.uniform(0.5, 1.5, shape))
            elif k == "kernel" or k.endswith("_kernel"):
                a = rng.standard_normal(shape) / np.sqrt(
                    np.prod(shape[:-1]))
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            elif "alpha" in k:
                a = rng.uniform(0.2, 0.5, shape)
            elif "PA" in k:
                a = rng.uniform(0.0, 0.5, shape)
            elif k in ("pe", "rel_pos_emb") or "cls_token" in k:
                a = rng.standard_normal(shape) * 0.5
            else:
                a = rng.standard_normal(shape) * 0.1
            out[k] = np.asarray(a, np.float32)
        return out

    return {"params": walk(shapes["params"], False),
            "batch_stats": walk(shapes.get("batch_stats", {}), True)}


def jax_model(version, **kw):
    args = dict(BASE, **WIDTHS[version], **kw)
    if version == "v32":
        args["version"] = "v32"
    return JAX_CLASSES[version](adj=ADJ, **args)


def port_model(version, t=T, **kw):
    return registry.build_model(f"aagcn_{version}",
                                dict(BASE, **WIDTHS[version], **kw),
                                device="cpu", num_frame=t)


def seeded_variables(model, x, seed=0):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    return fill(shapes, seed)


# the compile options of `jax_fast`: the backend's cheapest optimization
FAST = {"xla_backend_optimization_level": 0}


def jax_fast(fn, *args):
    """fn(*args) as one jitted program compiled with FAST, in numpy."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("version,kw", CASES,
                         ids=[f"{v}-{i}" for i, (v, _) in enumerate(CASES)])
def test_version_logits_match_jax(version, kw):
    """The JAX variables load strict into the port through its map, the
    eval logits agree, and the port's state dict maps back through JAX's
    import to the same variables."""
    x = _x(empty_from=6 if kw.get("classifier_type") == "CLS_MASK"
           else None)
    jm = jax_model(version, **kw)
    variables = seeded_variables(jm, x)
    want = jax_fast(lambda v, x: jm.apply(v, x)[0], variables,
                    jnp.asarray(x))
    model = port_model(version, **kw)
    sd = weights.model_state_dict(variables, f"aagcn_{version}")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    back = IMPORTS[version](model.state_dict())
    want_leaves, got_leaves = _leaves(variables), _leaves(back)
    assert set(got_leaves) == set(want_leaves)
    for key, value in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[key], value, err_msg=key)


@pytest.mark.parametrize("name", ["aagcn_v29", "aagcn_v33", "aagcn_v35",
                                  "aagcn_v36", "aagcn_v37"])
def test_broken_versions_raise_what_jax_raises(name):
    """v29, v33, v35, v36 and v37 are broken as shipped upstream: neither
    registry builds them, with the same KeyError, nor maps their
    weights."""
    with pytest.raises(KeyError) as jax_err:
        jax_registry.build_model(name, {})
    with pytest.raises(KeyError) as port_err:
        registry.build_model(name, {}, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(KeyError):
        weights.model_state_dict({"params": {}, "batch_stats": {}}, name)


def test_registry_names_and_the_t_sized_widths():
    """The reference paths alias the versions; aagcn_v32 is v31 with
    version 'v32' and bias-less layers; v31's spatial width follows
    num_frame, and another input length or another T's weights raise
    with both Ts."""
    for name, version, cls in (
            ("model.aagcn_v17.Model", "v17", tv.AAGCNv17),
            ("model.architecture.aagcn.aagcn_v24.Model", "v24", tv.AAGCNv24),
            ("model.aagcn_v30.Model", "v30", tv.AAGCNv30),
            ("model.architecture.aagcn.aagcn_v32.Model", "v32", tv.AAGCNv31),
            ("model.aagcn_v34.Model", "v34", tv.AAGCNv34)):
        assert registry.model_key(name) == f"aagcn_{version}"
        assert registry.waiting_item(name) is None
        built = registry.build_model(name, dict(BASE, **WIDTHS[version]),
                                     device="cpu", num_frame=T)
        assert type(built) is cls
    v32 = port_model("v32", trans_seq="sa-t", add_A=True)
    assert v32.version == "v32"
    names = set(v32.state_dict())
    assert "t_trans_enc_layers.0.norm1.weight" in names
    assert not any(n.endswith(("norm1.bias", "linear1.bias"))
                   for n in names if "trans_enc" in n)
    assert "s_trans_enc_layers.1.subset2.alpha" in names
    m60 = port_model("v31", t=60, trans_seq="sa-t", add_A=True)
    assert m60.backbone_frames == 20
    assert tuple(m60.s_trans_enc_layers[0]["subset0"].linear1.weight.shape) \
        == (16 * 20, 24 * 20)
    with pytest.raises(ValueError, match="T' = 4"):
        m60(torch.zeros(1, 3, T, 25, 2))
    with pytest.raises(ValueError, match="num_frame=12"):
        port_model("v31", trans_seq="sa-t", add_A=True).load_state_dict(
            m60.state_dict())


def test_attention_options_match_jax():
    """The versions' layer options against the JAX layers, at the spatial
    tokens of the cases above ((N*M, V, T'*C) = (4, 25, 96), FF 64, so
    that JAX compiles no new shapes): bias-less linears and LayerNorms
    with and without the attention's biases, a relative position bias
    (the skew), an additive mask with -inf, and alpha and global_attn
    injected after the softmax (the returned weights stay the plain
    softmax)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 25, 96)).astype(np.float32)
    mask = np.where(np.tril(np.ones((25, 25))) > 0, 0.0, -np.inf).astype(
        np.float32)
    inject = dict(additive_mask=mask, alpha=np.asarray([0.3], np.float32),
                  global_attn=rng.uniform(0, 0.5, (25, 25)).astype(
                      np.float32))
    for kw in (dict(bias=False, attn_bias=False),
               dict(bias=False, attn_bias=True, rel_pos_len=25),
               dict(pre_norm=True)):
        layer = jatt.TransformerEncoderLayer(num_heads=2, dim_feedforward=64,
                                             dropout=0.0, activation="gelu",
                                             **kw)
        variables = fill(jax.eval_shape(layer.init, jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
        port = tatt.TransformerEncoderLayer(96, 2, 64, dropout=0.0,
                                            activation="gelu", **kw)
        sd = {}
        weights._layer_out(sd, "l", variables["params"])
        port.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}, strict=True)
        want, want_attn = jax_fast(
            lambda v, x, kw: layer.apply(v, x, **kw), variables,
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in inject.items()})
        with torch.no_grad():
            got, got_attn = port.eval()(torch.from_numpy(x), **{
                k: torch.from_numpy(v) for k, v in inject.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                                   atol=1e-5)
    assert tuple(tatt.RelPosEmb1D(7, 4).rel_pos_emb.shape) == (13, 4)
