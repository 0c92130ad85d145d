"""The port's single-stream live demo on the CPU against the JAX package:
`ActionRecognition(expose_attention=True)` (agcn_tpu_torch/infer/
realtime.py, the graphs each unit records through models/exposure.py)
against JAX's recognizer for the same weights and frames, and `python -m
agcn_tpu_torch.infer` without `--serve` against the root infer.py.

AGCN's and AAGCN's weights are the port's seeded ones, every BN's
statistics those of a train-mode forward, so that eval normalizes as a
trained model's does (ROADMAP Queue 3; with random statistics the tenth
block's attention logits reach ~6e3 and its softmax saturates), moved to
JAX by its torch_import maps; the scan_blocks variables are those
stacked by group. SGN's are seeded numpy values in the shapes of
`jax.eval_shape` of its init (no init program to compile). The JAX
recognizers' forwards are compiled at XLA's cheapest backend level, at
small T. Tolerances: probabilities
and each graph 2e-4 (fp32 through ten blocks, another summation order),
results.txt's probabilities 1e-4 (the serving bar).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import infer as root_infer
from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.infer import ActionRecognition as JaxRecognition
from agcn_tpu.models import registry as jax_registry
from agcn_tpu.models.aagcn import AAGCN as JaxAAGCN
from agcn_tpu.models.agcn import AGCN as JaxAGCN
from agcn_tpu.train.checkpoint import save_checkpoint as jax_save
from agcn_tpu.utils.bn_fold import fold_agcn_bn_eval as jax_fold_agcn
from agcn_tpu.utils.torch_import import (aagcn_variables_from_torch,
                                         agcn_variables_from_torch)
from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.infer import ActionRecognition
from agcn_tpu_torch.infer.cli import main as cli_main
from agcn_tpu_torch.models import AAGCN, AGCN, registry
from agcn_tpu_torch.models.agcn import SCAN_GROUPS
from agcn_tpu_torch.ops import BatchNorm
from agcn_tpu_torch.utils import bn_fold
from agcn_tpu_torch.utils.weights import (aagcn_state_dict_from_variables,
                                          agcn_state_dict_from_variables,
                                          sgn_state_dict_from_variables)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7
ADJ = build_adjacency("ntu_rgb_d")
JAX_ADJ = jax_build_adjacency("ntu_rgb_d")
T = 16
FAST = {"xla_backend_optimization_level": 0}
SGN_ARGS = dict(num_class=NUM_CLASS, c_multiplier=0.25)


def _fill(shapes, seed):
    """Seeded values for a JAX variables tree: kernels
    normal(1 / sqrt(fan_in)), norm scales 0.5-1.5, biases normal(0.1),
    statistics mean normal(0.1), var 0.5-1.5."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
                continue
            s = v.shape
            if stats:
                a = (rng.standard_normal(s) * 0.1 if k == "mean"
                     else rng.uniform(0.5, 1.5, s))
            elif k == "kernel" or k.endswith("_kernel"):
                a = rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]))
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, s)
            else:
                a = rng.standard_normal(s) * 0.1
            out[k] = np.asarray(a, np.float32)
        return out

    return {"params": walk(shapes["params"], False),
            "batch_stats": walk(shapes.get("batch_stats", {}), True)}


def _seeded(model, x, seed):
    return _fill(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)), seed)


def _fast(rec):
    """The JAX recognizer's jitted forward compiled at FAST, once per
    input shape."""
    jitted, compiled = rec._forward, {}

    def forward(variables, x):
        if x.shape not in compiled:
            compiled[x.shape] = jitted.lower(variables, x).compile(
                compiler_options=FAST)
        return compiled[x.shape](variables, x)

    rec._forward = forward
    return rec


def _frames(seed, n=12):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 1, 25, 3)).astype(np.float32) * 0.3
            for _ in range(n)]


def _normalized(model, to_jax, seed):
    """The port model's seeded weights with every BN's affine off its init
    (the GCN BN starts at 1e-6), PA about the graph, AAGCN's attention
    branch live, and every BN's running statistics its batch statistics
    in a train-mode forward (statistics that normalize, as a trained
    model's do), as JAX variables."""
    rng = np.random.default_rng(seed)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".alpha") or ".conv_ta." in name \
                    or ".fc2c." in name:
                p.copy_(torch.from_numpy(rng.uniform(
                    0.1, 0.3, p.shape).astype(np.float32)))
            elif name.endswith(".PA"):
                p.add_(torch.from_numpy(rng.standard_normal(
                    p.shape).astype(np.float32) * 0.05))
        for m in norms:
            m.weight.copy_(torch.from_numpy(rng.uniform(
                0.5, 1.5, m.weight.shape).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(rng.standard_normal(
                m.bias.shape).astype(np.float32) * 0.1))
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        x = rng.standard_normal((2, 3, T, 25, 2)).astype(np.float32)
        model.train()(torch.from_numpy(x))
        for m in norms:  # undo the momentum-0.1 update from (0, 1)
            m.running_mean.div_(0.1)
            m.running_var.sub_(0.9).div_(0.1).clamp_(min=1e-3)
    return jax.tree_util.tree_map(np.asarray, to_jax(model.state_dict()))


def _scanned(variables):
    """Unrolled JAX AGCN variables in the scan_blocks layout: each group's
    blocks stacked on a leading axis under `<group>.block`
    (agcn_tpu/models/agcn.py:258-283)."""
    out = {}
    for col, tree in variables.items():
        tree = dict(tree)
        for group, blocks in SCAN_GROUPS.items():
            out_blocks = [tree.pop(b) for b in blocks]
            tree[group] = {"block": jax.tree_util.tree_map(
                lambda *leaves: np.stack(leaves), *out_blocks)}
        out[col] = tree
    return out


def _cases():
    """(label, JAX model, JAX variables, port model, recognizer kwargs)."""
    cases = []
    unrolled = _normalized(
        AGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
             generator=torch.Generator().manual_seed(1)),
        agcn_variables_from_torch, seed=2)
    for scan in (False, True):
        jmodel = JaxAGCN(num_class=NUM_CLASS, adj=JAX_ADJ, scan_blocks=scan)
        variables = _scanned(unrolled) if scan else unrolled
        port = AGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
                    formulation="pallas", scan_blocks=scan)
        port.load_state_dict(agcn_state_dict_from_variables(variables),
                             strict=True)
        cases.append((f"agcn scan_blocks={scan}", jmodel, variables, port,
                      dict(max_seq_length=T)))
    variables = _normalized(
        AAGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
              generator=torch.Generator().manual_seed(3)),
        aagcn_variables_from_torch, seed=4)
    port = AAGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
                 formulation="pallas", eval_formulation="pallas")
    port.load_state_dict(aagcn_state_dict_from_variables(variables),
                         strict=True)
    cases.append(("aagcn", JaxAAGCN(num_class=NUM_CLASS, adj=JAX_ADJ),
                  variables, port, dict(max_seq_length=T)))
    jmodel = jax_registry.build_model("sgn", SGN_ARGS)
    variables = _seeded(jmodel, np.zeros((1, 20, 75), np.float32), seed=5)
    port = registry.build_model("sgn", SGN_ARGS, device="cpu", num_frame=20)
    port.load_state_dict(sgn_state_dict_from_variables(variables),
                         strict=True)
    cases.append(("sgn", jmodel, variables, port, dict(
        kind="sgn", max_seq_length=48, multi_test=2, normalize=False,
        sgn_dataloader_args={"seg": 20})))
    return cases


def test_recognizer_exposes_the_jax_graphs():
    """The unrolled AGCN (graphs in JAX's sorted key order: l1, l10, l2,
    ...), a scan_blocks AGCN whose JAX variables (stacked groups) load
    strict through the unstacking map (graphs in block order), a 10-block
    AAGCN and a small SGN (its G list, kept without exposure too): the
    same probabilities, and `last_attention` of the same length, order,
    shapes and values. Then the scanned model folds: the port's fold of
    its state dict gives the unfolded logits and equals JAX's fold of the
    stacked variables."""
    for label, jmodel, variables, port, kw in _cases():
        jrec = _fast(JaxRecognition(jmodel, variables,
                                    expose_attention=True, **kw))
        recs = [ActionRecognition(port, expose_attention=expose, **kw)
                for expose in (True, False)]
        for f in _frames(7, n=kw["max_seq_length"] - 4):
            for r in (jrec, *recs):
                r.append_frame(f)
        want_label, want = jrec.predict()
        for r in recs:
            got_label, got = r.predict()
            assert got_label == want_label, label
            np.testing.assert_allclose(got, want, atol=2e-4, err_msg=label)
        want_g = [np.asarray(g, np.float32) for g in jrec.last_attention]
        got_g = recs[0].last_attention
        assert len(got_g) == len(want_g) == (1 if label == "sgn" else 10)
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            assert g.shape == w.shape and g.dtype == np.float32, (label, i)
            np.testing.assert_allclose(g, w, atol=2e-4,
                                       err_msg=f"{label} graph {i}")
        if label == "sgn":  # JAX keeps SGN's G whatever the flag says
            assert recs[1].last_attention is not None
            assert got_g[0].shape == (2, 20, 25, 25)  # the two crops' G
        else:
            assert recs[1].last_attention is None
        if label.startswith("agcn"):
            # JAX's order: sorted keys, each scanned group split in order
            blocks = (list(range(1, 11)) if "True" in label
                      else [1, 10, 2, 3, 4, 5, 6, 7, 8, 9])
            for g, b in zip(got_g, blocks):
                pa = port.get_submodule(f"l{b}.gcn1").PA.detach().numpy()
                # a1 - softmax part = A + PA: each column of the softmax
                # sums to 1 over the source joint
                a = ADJ + pa
                np.testing.assert_allclose((g - a).sum(axis=-2), 1.0,
                                           atol=1e-5)
        if label == "agcn scan_blocks=True":
            x = torch.from_numpy(np.random.default_rng(8).standard_normal(
                (2, 3, T, 25, 2)).astype(np.float32))
            folded = bn_fold.fold_agcn_bn_eval(port.state_dict())
            fold_model = AGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
                              formulation="pallas", scan_blocks=True,
                              fold_bn=True)
            fold_model.load_state_dict(folded, strict=True)
            with torch.inference_mode():
                np.testing.assert_allclose(
                    fold_model.eval()(x).numpy(), port.eval()(x).numpy(),
                    atol=2e-4)
            jax_folded = agcn_state_dict_from_variables(
                jax_fold_agcn(variables))
            for k, v in jax_folded.items():
                if not k.endswith("num_batches_tracked"):
                    np.testing.assert_allclose(folded[k].numpy(), v.numpy(),
                                               atol=1e-6, err_msg=k)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def test_cli_single_stream_answers_as_the_root_cli(tmp_path, capsys,
                                                   monkeypatch):
    """A directory of two seeded recordings through `python -m
    agcn_tpu_torch.infer` (the port's `formulation: pallas`) and the root
    infer.py (the JAX default formulation: the same function), on one
    JAX npz checkpoint that both read: the same `== file` and `frame ...`
    lines, results.txt (probabilities 1e-4) and attention PNG names.
    `--serve 2` still answers as the root CLI's `--serve 2` does, and
    `--save-attention` fails at argument time, naming matplotlib, where
    matplotlib cannot be found."""
    variables = _normalized(
        AGCN(num_class=NUM_CLASS, adj=ADJ, device="cpu",
             generator=torch.Generator().manual_seed(5)),
        agcn_variables_from_torch, seed=6)
    jax_save(str(tmp_path / "w"), variables, use_orbax=False)
    weights = str(tmp_path / "w.npz")
    rec = tmp_path / "rec"
    rec.mkdir()
    rng = np.random.default_rng(0)
    for i, name in enumerate(("cam1", "cam0")):
        np.save(rec / f"{name}.npy", rng.standard_normal(
            (3, 20 + 5 * i, 25, 2)).astype(np.float32) * 0.3)
        os.utime(rec / f"{name}.npy", (10 + i, 10 + i))  # cam1 first
    configs = {}
    for side, args in (("root", {}), ("port", {"formulation": "pallas"})):
        configs[side] = str(tmp_path / f"{side}.yaml")
        with open(configs[side], "w") as f:
            yaml.safe_dump({"model": "agcn", "model_args": dict(
                num_class=NUM_CLASS, **args)}, f)
    # the root CLI's recognizer (imported inside its main) compiled at FAST
    monkeypatch.setattr("agcn_tpu.infer.ActionRecognition",
                        lambda *a, **k: _fast(JaxRecognition(*a, **k)))
    out = {}
    for side, main in (("root", root_infer.main), ("port", cli_main)):
        lines = _run(main, [
            "--config", configs[side], "--weights", weights, "--input",
            str(rec), "--interval", "10", "--max-frame", "32", "--device",
            "cpu", "--out-folder", str(tmp_path / side),
            "--save-attention", str(tmp_path / f"{side}_attn")], capsys)
        results = np.loadtxt(tmp_path / side / "results.txt",
                             delimiter=",")
        out[side] = (lines, results,
                     sorted(os.listdir(tmp_path / f"{side}_attn")))
    lines, results, pngs = out["port"]
    assert lines == out["root"][0]
    assert [ln.split(":")[0] for ln in lines] == [
        f"== {rec / 'cam1.npy'}", "frame 10", "frame 20",
        f"== {rec / 'cam0.npy'}", "frame 10", "frame 20"]
    np.testing.assert_array_equal(results[:, :2], out["root"][1][:, :2])
    np.testing.assert_allclose(results[:, 2], out["root"][1][:, 2],
                               atol=1e-4)
    assert pngs == out["root"][2] == [
        "cam0_f10_g0.png", "cam0_f20_g0.png", "cam1_f10_g0.png",
        "cam1_f20_g0.png"]

    # --serve: the multi-stream answers, as the root CLI serves them
    served = {side: [ln for ln in _run(main, [
        "--config", configs[side], "--weights", weights, "--input",
        str(rec), "--serve", "2", "--interval", "10", "--max-frame", "32",
        "--device", "cpu"], capsys) if ln.startswith("[cam")]
        for side, main in (("root", root_infer.main), ("port", cli_main))}
    assert served["port"] == served["root"] and len(served["port"]) == 4

    # no matplotlib: the flag fails before any model is built
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    with pytest.raises(SystemExit):
        cli_main(["--config", configs["port"], "--weights", weights,
                  "--input", str(rec), "--device", "cpu",
                  "--save-attention", str(tmp_path / "none")])
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()
