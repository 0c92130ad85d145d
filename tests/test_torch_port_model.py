"""The port's AGCN against the JAX package's on the CPU: JAX variables
moved by the port's `agcn_state_dict_from_variables` with a strict load,
eval logits within atol 2e-4 (the parity bar of tests/test_agcn.py) for
the default 'agg' form, for formulation='pallas' (JAX runs the Pallas
kernel in interpret mode on the CPU) and for use_pallas=True. Also the
weight files, the copied numpy modules, and the port's import isolation.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.data.gen.preprocess import \
    pre_normalization as jax_pre_normalization
from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.models.agcn import AGCN as JaxAGCN
from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu_torch.data.gen.preprocess import pre_normalization
from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models import AGCN, build_model
from agcn_tpu_torch.utils.config import load_config
from agcn_tpu_torch.utils.weights import (agcn_state_dict_from_variables,
                                          load_checkpoint, model_state_dict)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASS = 7


def _randomize(variables, seed=0):
    """Seeded BN statistics/affines and PA (numpy), so every layer —
    the GCN too, whose BN starts at scale 1e-6 — reaches the logits."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif k == "PA":
                out[k] = rng.standard_normal(v.shape).astype(np.float32) \
                    * 0.01
            elif stats and k == "mean":
                out[k] = rng.standard_normal(v.shape).astype(np.float32) \
                    * 0.1
            elif stats and k == "var" or (not stats and k == "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif not stats and k == "bias" and v.ndim == 1:
                out[k] = np.asarray(v) + rng.standard_normal(
                    v.shape).astype(np.float32) * 0.1
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


@pytest.fixture(scope="module")
def jax_agcn():
    adj = jax_build_adjacency("ntu_rgb_d")
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 16, 25, 2)).astype(np.float32)
    variables = JaxAGCN(num_class=NUM_CLASS, adj=adj).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return adj, _randomize(dict(variables)), x


def _port(adj, variables, **kw):
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu", **kw)
    model.load_state_dict(agcn_state_dict_from_variables(variables),
                          strict=True)
    return model.eval()


def _interpret_fused_gcn(monkeypatch):
    """The test-side patch of tests/test_pallas_gcn.py:63-75: the JAX
    use_pallas path calls its Pallas kernel in interpret mode."""
    import agcn_tpu.ops.pallas.gcn_kernel as gk

    orig = gk.fused_gcn
    monkeypatch.setattr(
        gk, "fused_gcn",
        lambda x, a1, w, time_tile=64, interpret=False:
        orig(x, a1, w, time_tile, True))


@pytest.mark.parametrize("kw", [{}, {"formulation": "pallas"},
                                {"formulation": "pallas_hybrid"},
                                {"use_pallas": True}],
                         ids=["agg", "pallas", "pallas_hybrid", "use_pallas"])
def test_agcn_logits_match_jax(jax_agcn, kw, monkeypatch):
    adj, variables, x = jax_agcn
    if kw.get("use_pallas"):
        _interpret_fused_gcn(monkeypatch)
    want = np.asarray(JaxAGCN(num_class=NUM_CLASS, adj=adj, **kw).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(adj, variables, **kw)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, NUM_CLASS)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_agcn_bf16_close_to_jax_bf16(jax_agcn):
    """bf16 compute: both frameworks round at the same places (activations
    and weights cast, fp32 BN affine and softmax); sums of other order
    leave ~3 significant digits per layer — held at 2% of the logit
    scale."""
    adj, variables, x = jax_agcn
    kw = dict(formulation="pallas")
    want = np.asarray(JaxAGCN(num_class=NUM_CLASS, adj=adj,
                              dtype=jnp.bfloat16, **kw).apply(
        variables, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = _port(adj, variables, dtype=torch.bfloat16, **kw)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_state_dict_names_are_the_reference_names(jax_agcn):
    adj, variables, _ = jax_agcn
    sd = _port(adj, variables).state_dict()
    assert set(sd) == set(agcn_state_dict_from_variables(variables))
    for key, shape in [("l1.gcn1.PA", (3, 25, 25)),
                       ("l1.gcn1.conv_a.0.weight", (16, 3, 1, 1)),
                       ("l1.gcn1.down.0.weight", (64, 3, 1, 1)),
                       ("l1.tcn1.conv.weight", (64, 64, 9, 1)),
                       ("l5.residual.conv.weight", (128, 64, 1, 1)),
                       ("data_bn.running_mean", (150,)),
                       ("fc.weight", (NUM_CLASS, 256))]:
        assert tuple(sd[key].shape) == shape, key
    assert "l1.gcn1.A" not in sd  # the static stack is no parameter


def test_train_mode_and_unported_options_raise():
    """Train mode runs (the training forward, batch statistics); the
    options the port does not have yet raise."""
    adj = build_adjacency("ntu_rgb_d")
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu")
    assert model.training  # torch's default; serving calls .eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 8, 25, 2)).astype(np.float32))
    assert model(x).shape == (2, NUM_CLASS)
    assert int(model.data_bn.num_batches_tracked) == 1
    with pytest.raises(NotImplementedError, match="scan_blocks"):
        AGCN(adj=adj, device="cpu", scan_blocks=True)
    with pytest.raises(NotImplementedError, match="edge_mesh"):
        AGCN(adj=adj, device="cpu", edge_mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("aagcn_transformer", {}, device="cpu")


def test_default_device_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    adj = build_adjacency("ntu_rgb_d")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        AGCN(num_class=NUM_CLASS, adj=adj)
    cfg = load_config(os.path.join(REPO, "configs", "ntu60_xview",
                                   "test_joint.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(cfg.model, cfg.model_args)


def test_seeded_init_is_deterministic_and_leaves_global_rng():
    adj = build_adjacency("ntu_rgb_d")
    state = torch.get_rng_state()
    a = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
             generator=torch.Generator().manual_seed(5)).state_dict()
    b = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu",
             generator=torch.Generator().manual_seed(5)).state_dict()
    assert torch.equal(state, torch.get_rng_state())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # reference init: last GCN BN at 1e-6, PA at 1e-6
    assert torch.all(a["l3.gcn1.bn.weight"] == 1e-6)
    assert torch.all(a["l3.gcn1.PA"] == 1e-6)


def test_checkpoint_files_load_strict(jax_agcn, tmp_path):
    adj, variables, x = jax_agcn
    base = _port(adj, variables)
    # the JAX package's npz checkpoint
    save_checkpoint(str(tmp_path / "ckpt"), variables, use_orbax=False)
    npz = model_state_dict(load_checkpoint(str(tmp_path / "ckpt")))
    # a reference .pt state dict
    torch.save(base.state_dict(), tmp_path / "w.pt")
    pt = model_state_dict(load_checkpoint(str(tmp_path / "w.pt")))
    for sd in (npz, pt):
        model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            torch.testing.assert_close(model.eval()(torch.from_numpy(x)),
                                       base(torch.from_numpy(x)))
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="npz"):
        load_checkpoint(str(tmp_path / "orbax_dir"))


def test_ddp_saved_state_dict_loads_every_weight(jax_agcn, tmp_path):
    """A reference .pt saved from a DDP-wrapped model (`module.` names)
    loads through the trainer's path: every tensor equals the source and
    nothing is skipped or left at its init."""
    from agcn_tpu_torch.train.checkpoint import load_checkpoint as load_ckpt
    from agcn_tpu_torch.train.checkpoint import load_model_weights

    adj, variables, _ = jax_agcn
    source = _port(adj, variables).state_dict()
    torch.save({f"module.{k}": v for k, v in source.items()},
               tmp_path / "ddp.pt")
    model = AGCN(num_class=NUM_CLASS, adj=adj, device="cpu")
    logged = []
    load_model_weights(model, load_ckpt(str(tmp_path / "ddp.pt"))["model"],
                       log=logged.append)
    assert logged == []
    loaded = model.state_dict()
    assert set(loaded) == set(source)
    for name, want in source.items():
        assert torch.equal(loaded[name], want), name


def test_pre_normalization_matches_jax_numpy_path():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((3, 3, 20, 25, 2)).astype(np.float32)
    data[0, :, :4] = 0.0   # leading null frames
    data[1, :, 12:] = 0.0  # trailing null frames
    data[2, :, :, :, 1] = 0.0  # one empty body
    want = jax_pre_normalization(data, native_ok=False)
    np.testing.assert_array_equal(pre_normalization(data), want)


def test_skeleton_file_reading_matches_jax(tmp_path):
    """`.skeleton` recordings (the CLI's other input): the port's python
    parser and 2-max-energy body selection against the JAX package's."""
    from agcn_tpu.data.gen.ntu import read_xyz as jax_read_xyz
    from agcn_tpu_torch.data.gen.ntu import read_xyz

    rng = np.random.default_rng(0)
    bodies = rng.standard_normal((3, 12, 25, 3)) * [[[[1.0]]], [[[0.1]]],
                                                    [[[2.0]]]]
    lines = ["12"]
    for t in range(12):
        lines.append("3")
        for b in range(3):
            lines += [f"{b} 0 0 0 0 0 0 0 0 0", "25"]
            lines += [f"{x:.6f} {y:.6f} {z:.6f} 0 0 0 0 0 0 0 0 0"
                      for x, y, z in bodies[b, t]]
    path = tmp_path / "S001C001P001R001A001.skeleton"
    path.write_text("\n".join(lines) + "\n")
    got = read_xyz(str(path))
    assert got.shape == (3, 12, 25, 2)
    np.testing.assert_allclose(got, jax_read_xyz(str(path)), atol=1e-6)


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "agcn_tpu")
# the training path's modules, which the fresh-process check must reach
_TRAINING_MODULES = tuple(f"agcn_tpu_torch.{m}" for m in (
    "main", "train.trainer", "train.steps", "train.optim", "train.losses",
    "train.checkpoint", "data.feeder", "data.pipeline", "data.transforms",
    "tools.grad_parity"))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_nothing_of_jax():
    """Every import statement of the port and of chip_smoke.py, lazy ones
    inside functions included."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "agcn_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_port_modules_load_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import agcn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    agcn_tpu_torch.__path__, 'agcn_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "    'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN}]\n"
        f"missing = sorted(set({_TRAINING_MODULES}) - set(mods))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 20 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
