"""The port's small leftovers on the CPU, each case its own test: the
STGAT graph builders (agcn_tpu_torch/graph/build.py) equal to the JAX
package's for every skeleton and parameter, the drawing functions
(utils/visualization.py, matplotlib's Agg backend) and `explore
--render-sample`, the registry's plug-in path, and the root
grid_results.py and tools/gen_grid.py over the port trainer's work dirs.
"""

import json
import os

import matplotlib
import numpy as np
import pytest
import torch
import yaml
from torch import nn

import grid_results
from agcn_tpu.data.gen import explore as jax_explore
from agcn_tpu.graph import build as jax_build
from agcn_tpu.graph import get_skeleton as jax_skeleton
from agcn_tpu_torch.data.gen.__main__ import main as datagen_main
from agcn_tpu_torch.graph import available_skeletons, get_skeleton
from agcn_tpu_torch.graph import build
from agcn_tpu_torch.models import AGCN, registry
from agcn_tpu_torch.tools.sgn_raw_tree import skeleton_text, \
    write_sgn_raw_tree
from agcn_tpu_torch.utils import visualization
from tests.torch_port_threads import one_torch_thread  # noqa: F401
from tools.gen_grid import main as gen_grid_main

matplotlib.use("Agg")

SKELETONS = available_skeletons()


def _binary(mod, sk, **kw):
    return mod.binary_adjacency(sk, **kw)


# builder -> the calls to make of it, each a function of (module,
# skeleton) and a label: every parameter of the JAX builder
BUILDERS = {
    "binary_adjacency": [
        (f"with_self={w}", lambda m, sk, w=w: _binary(m, sk, with_self=w))
        for w in (True, False)],
    "k_adjacency": [
        (f"k={k} with_self={w} self_factor={f}",
         lambda m, sk, k=k, w=w, f=f: m.k_adjacency(
             _binary(m, sk, with_self=False), k, with_self=w,
             self_factor=f))
        for k in (0, 1, 2, 3) for w in (False, True) for f in (1.0, 0.5)],
    "separated_adjacency": [
        (f"k_list={ks}", lambda m, sk, ks=ks: m.separated_adjacency(
            _binary(m, sk), ks))
        for ks in (list(range(13)), [0, 2, 4], [1, 3])],
    "k_total_adjacency": [
        (f"k={k}", lambda m, sk, k=k: m.k_total_adjacency(_binary(m, sk), k))
        for k in (0, 1, 3)],
    "spatial_temporal_graph": [
        (f"sample_size={n}", lambda m, sk, n=n: m.spatial_temporal_graph(
            _binary(m, sk, with_self=False), n))
        for n in (1, 3)],
    "expanded_graph": [
        (f"variant={v}", lambda m, sk, v=v: m.expanded_graph(sk, variant=v))
        for v in (1, 2, 3)],
    "strengthened_graph": [("", lambda m, sk: m.strengthened_graph(sk))],
    "adj_matrix_graph": [("", lambda m, sk: m.adj_matrix_graph(sk.name))],
}


def _outcome(fn, mod, sk):
    """The builder's arrays, or the type of the exception it raises (the
    NTU-only graphs index past a smaller skeleton)."""
    try:
        out = fn(mod, sk)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e)
    if isinstance(out, np.ndarray):
        return [out]
    return [getattr(out, f) for f in ("a_binary", "a_binary_with_i", "a",
                                      "a_sep")]


@pytest.mark.parametrize("skeleton", SKELETONS)
@pytest.mark.parametrize("builder", list(BUILDERS))
def test_stgat_builders_equal_jax(builder, skeleton):
    """The port's builder equals JAX's exactly (values, dtype, shape), or
    raises the same exception type, for each of its parameters."""
    sk, jsk = get_skeleton(skeleton), jax_skeleton(skeleton)
    assert sk.name == jsk.name == skeleton
    for label, fn in BUILDERS[builder]:
        got, want = _outcome(fn, build, sk), _outcome(fn, jax_build, jsk)
        if isinstance(want, type):
            assert got is want, (label, got, want)
            continue
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape, label
            np.testing.assert_array_equal(g, w, err_msg=label)


def test_graph_package_exports_what_jax_exports():
    import agcn_tpu.graph as jax_graph
    import agcn_tpu_torch.graph as graph

    assert set(jax_graph.__all__) <= set(graph.__all__)


DRAWINGS = {
    "attention (V, V)": lambda p: visualization.plot_attention(
        np.random.default_rng(0).random((25, 25)), save_path=p),
    "attention (K, V, V)": lambda p: visualization.plot_attention(
        np.random.default_rng(1).random((3, 25, 25)), save_path=p),
    "attention (B, T, V, V)": lambda p: visualization.plot_attention(
        np.random.default_rng(2).random((2, 4, 25, 25)), save_path=p),
    "skeleton 3d": lambda p: visualization.visualize_skeleton(
        np.random.default_rng(3).random((1, 3, 4, 25, 2)), save_path=p),
    "skeleton 2d kinetics": lambda p: visualization.visualize_skeleton(
        np.random.default_rng(4).random((2, 2, 3, 18, 2)), is_3d=False,
        skeleton_name="kinetics", sample=1, save_path=p),
}


@pytest.mark.parametrize("case", list(DRAWINGS))
def test_drawings_write_their_files(case, tmp_path):
    path = str(tmp_path / ("g.png" if case.startswith("attention")
                           else "s.gif"))
    DRAWINGS[case](path)
    assert os.path.getsize(path) > 0


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """A seeded synthetic NTU raw tree (tools/sgn_raw_tree.py) and one
    short sample of two bodies beside its samples."""
    _, raw, names = write_sgn_raw_tree(str(tmp_path_factory.mktemp("raw")),
                                       samples=6)
    rng = np.random.default_rng(0)
    frames = [[(b, rng.standard_normal((25, 3)) * 0.2 + b) for b in (0, 1)]
              for _ in range(5)]
    short = "S002C001P001R001A007"
    with open(os.path.join(raw, f"{short}.skeleton"), "w") as f:
        f.write(skeleton_text(frames, 72057594037931000))
    return raw, names, short


def test_render_sample_draws_what_jax_draws(raw_tree, monkeypatch):
    """The port's render_sample hands visualize_skeleton JAX's batch
    (parsed, padded, pre-normalized) for each sample of the tree."""
    from agcn_tpu_torch.data.gen import explore
    from agcn_tpu.utils import visualization as jax_visualization

    raw, names, short = raw_tree
    seen = {"port": [], "jax": []}
    for side, mod in (("port", visualization), ("jax", jax_visualization)):
        monkeypatch.setattr(mod, "visualize_skeleton",
                            lambda data, seen=seen[side], **kw:
                            seen.append((data, kw)))
    for name in names + [short]:
        for side, render in (("port", explore.render_sample),
                             ("jax", jax_explore.render_sample)):
            assert render(raw, f"{name}.skeleton", "x.gif") == "x.gif"
    assert len(seen["port"]) == len(seen["jax"]) == len(names) + 1
    for (got, gkw), (want, wkw) in zip(seen["port"], seen["jax"]):
        assert gkw == wkw
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_explore_render_sample_writes_its_animation(raw_tree, tmp_path,
                                                    capsys):
    raw, names, short = raw_tree
    out = tmp_path / "short.gif"
    datagen_main(["explore", "--data-path", raw, "--render-sample",
                  f"{short}.skeleton", "--save", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"samples: {len(names) + 1}"
    assert lines[-1] == f"saved {out}" and out.stat().st_size > 0


class Toy(nn.Module):
    """A user model for the plug-in path."""

    def __init__(self, num_class, width=4):
        super().__init__()
        self.fc = nn.Linear(width, num_class)

    def forward(self, x):
        return self.fc(x)


def make_toy(num_class, width=4):
    return Toy(num_class, width=width)


@pytest.mark.parametrize("name", ["tests.test_torch_port_leftovers.Toy",
                                  "tests.test_torch_port_leftovers.make_toy"])
def test_plug_in_builds_a_user_module(name):
    model = registry.build_model(name, {"num_class": 3, "width": 5},
                                 device="cpu")
    assert isinstance(model, Toy) and model.fc.weight.shape == (3, 5)
    assert model(torch.zeros(2, 5)).shape == (2, 3)


def test_aliases_and_refusals_come_before_plug_ins():
    """A reference path the registry aliases builds its model; an
    unaliased `model.` path is an archived experiment (KeyError), not a
    module to import; a plug-in that does not exist raises the import's
    error."""
    assert isinstance(registry.build_model("model.agcn.Model", {},
                                           device="cpu"), AGCN)
    with pytest.raises(KeyError, match="archived reference experiment"):
        registry.build_model("model.aagcn_v5.Model", {}, device="cpu")
    with pytest.raises(ModuleNotFoundError):
        registry.build_model("no_such_package.Model", {}, device="cpu")


def test_grid_tools_read_the_port_trainers_work_dirs(tmp_path, capsys):
    """tools/gen_grid.py writes a two-cell grid from a base recipe, the
    port's trainer (`agcn_tpu_torch.main --device cpu`, a one-block AAGCN
    of width 8) runs each cell, and grid_results.py reads both work
    dirs: each cell's best eval top1 from its metrics.jsonl, and its grid
    keys from its config.yaml into the heatmap."""
    from agcn_tpu_torch.main import main as train_main

    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 3, 8, 25, 2)).astype(np.float32)
    np.save(tmp_path / "x.npy", data)
    with open(tmp_path / "y.pkl", "wb") as f:
        import pickle
        pickle.dump(([f"s{i}" for i in range(6)], [i % 3 for i in range(6)]),
                    f)
    feeder = {"data_path": str(tmp_path / "x.npy"),
              "label_path": str(tmp_path / "y.pkl")}
    base = {"work_dir": str(tmp_path / "unused"), "model": "aagcn",
            "model_args": {"num_class": 3, "model_layers": 101,
                           "backbone_dim": 8},
            "train_feeder_args": feeder, "test_feeder_args": feeder,
            "batch_size": 3, "test_batch_size": 3, "num_epoch": 2,
            "eval_interval": 1, "save_interval": 2, "base_lr": 0.05,
            "seed": 1, "print_log": False, "num_worker": 0,
            "device": "cpu"}
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(base))
    cells = gen_grid_main([str(tmp_path / "base.yaml"), str(tmp_path / "grid"),
                           "--axis", "base_lr=[0.05,0.1]",
                           "--axis", "model_args.backbone_dim=[8]"])
    assert len(cells) == 2
    for cell in cells:
        train_main(["--config", cell])
    capsys.readouterr()
    pattern = str(tmp_path / "grid" / "*")
    results = grid_results.main([pattern, "--heatmap",
                                 str(tmp_path / "hm.png"), "--row-key",
                                 "base_lr", "--col-key",
                                 "model_args.backbone_dim"])
    assert sorted(results) == sorted(os.path.dirname(c) for c in cells)
    for work, best in results.items():
        with open(os.path.join(work, "metrics.jsonl")) as f:
            evals = [r["top1"] for r in map(json.loads, f)
                     if r.get("kind") == "eval"]
        assert len(evals) == 2 and best == max(evals)
    assert sorted(grid_results.run_config(w)["base_lr"]
                  for w in results) == [0.05, 0.1]
    assert (tmp_path / "hm.png").stat().st_size > 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"heatmap saved: {tmp_path / 'hm.png'}")
