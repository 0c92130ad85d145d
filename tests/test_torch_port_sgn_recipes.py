"""The two SGN recipes of the run knobs through the port's `Trainer`
against agcn_tpu's, on small synthetic SGN pickles on the CPU (after JAX
tests/test_ledger_recipes.py:93 and tests/test_multi_step.py:80):

- `train_sgn_scan8.yaml` (`steps_per_call: 8`): the port at K = 3 (8
  batches an epoch: two groups and a remainder) and at the recipe's K = 8
  (one group) equals its K = 1 run, and tracks the JAX `Trainer` at K = 3;
- `train_sgn_fsim_sam.yaml` (SAM, `fsim_mode: 1`, gcn_fpn 0 with three
  levels of temporal branches): the train and eval metrics, `fsim`
  among them, track the JAX `Trainer`'s.

Each recipe is shrunk in width only (c_multiplier 0.25, sgcn_dims (32,
64, 64), 4 classes) with dropout2d 0 (the two frameworks draw other
masks), batch 4, one epoch, both runs started from one checkpoint the JAX
package saved (every unit's w1 random).

Tolerances: per-step losses and the epoch's metrics 1e-3 relative (eight
fp32 steps on the same batches), top-k equal; the port's K-step runs bit
for bit against its K = 1 run (the same CPU computations).
"""

import json
import os
import re
import warnings

import numpy as np
import pytest
import torch
import yaml

from agcn_tpu_torch.main import main
from tests.test_torch_port_sgn_data import _initial_checkpoint, _write_split
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {name: os.path.join(REPO, "configs", "ntu60_xview",
                              f"train_{name}.yaml")
           for name in ("sgn_scan8", "sgn_fsim_sam")}
_STEP = re.compile(r"epoch (\d+) step (\d+)/(\d+) loss ([-\d.]+)")


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sgn_recipes"))
    # 28 + 4 merged: 8 training batches of 4; 8 test samples of 5 crops
    return tmp, {name: _write_split(tmp, name, n, seed) for name, n, seed in
                 (("NTU_CV_train", 28, 1), ("NTU_CV_val", 4, 2),
                  ("NTU_CV_test", 8, 3))}


def _recipe(name, paths, work, **over):
    with open(RECIPES[name]) as f:
        recipe = yaml.safe_load(f)
    (dp, lp), (tp, tl) = paths["NTU_CV_train"], paths["NTU_CV_test"]
    recipe.update(
        work_dir=work, batch_size=4, test_batch_size=4, num_epoch=1,
        eval_interval=1, save_interval=1, log_interval=1, seed=7,
        print_log=False, num_worker=0, device="cpu", mesh_data=1,
        show_topk=[1, 2],
        train_feeder_args=dict(recipe["train_feeder_args"], data_path=dp,
                               label_path=lp),
        test_feeder_args=dict(recipe["test_feeder_args"], data_path=tp,
                              label_path=tl),
        model_args=dict(recipe["model_args"], num_class=4,
                        c_multiplier=0.25, sgcn_dims=[32, 64, 64],
                        sgcn_g_proj_dim=64, dropout2d=0.0), **over)
    return recipe


def _jax_run(recipe, init):
    from agcn_tpu.train.trainer import Trainer as JaxTrainer
    from agcn_tpu.utils.config import Config as JaxConfig

    cfg = JaxConfig()
    for key, value in dict(recipe, weights=init).items():
        setattr(cfg, key, value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JaxTrainer(cfg).start()


def _port_run(recipe, init=None):
    path = recipe["work_dir"] + ".yaml"
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    main(["--config", path] + (["--weights", init] if init else []))


def _steps(work):
    with open(os.path.join(work, "log.txt")) as f:
        return [(int(m[1]), int(m[2]), int(m[3]), float(m[4]))
                for m in _STEP.finditer(f.read())]


def _metrics(work, kind):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


@pytest.fixture(scope="module")
def scan_runs(splits):
    tmp, paths = splits
    recipe = _recipe("sgn_scan8", paths, "")
    os.makedirs(os.path.join(tmp, "scan"))
    init = _initial_checkpoint(os.path.join(tmp, "scan"),
                               recipe["model_args"])
    works = {}
    for who, spc in (("jax", 3), ("port", 1), ("port", 3), ("port", 8)):
        work = os.path.join(tmp, f"scan_{who}{spc}")
        run = _recipe("sgn_scan8", paths, work, steps_per_call=spc)
        (_jax_run if who == "jax" else _port_run)(run, init)
        works[who, spc] = work
    return works


@pytest.mark.parametrize("spc", [3, 8])
def test_steps_per_call_equals_the_sequential_run(scan_runs, spc):
    """K steps back to back: the log's every step and the checkpoint (model
    and optimizer state) of the K = 1 run, bit for bit; the metrics read
    at the epoch's end are its last step's."""
    grouped, single = scan_runs["port", spc], scan_runs["port", 1]
    assert _steps(grouped) == _steps(single)
    assert [s[:3] for s in _steps(grouped)] == [(0, i, 8)
                                                 for i in range(1, 9)]
    states = [torch.load(os.path.join(w, "checkpoints", "epoch_1.pt"),
                         weights_only=False) for w in (grouped, single)]
    for name, value in states[1]["model"].items():
        assert torch.equal(states[0]["model"][name], value), name
    opt = [s["optimizer"]["opt"]["state"] for s in states]
    for i, st in opt[1].items():  # Adam's moments and count
        for k, v in st.items():
            assert (torch.equal(opt[0][i][k], v) if torch.is_tensor(v)
                    else opt[0][i][k] == v), (i, k)
    assert states[0]["step"] == states[1]["step"] == 8
    rows = [_metrics(w, "train")[0] for w in (grouped, single)]
    assert rows[0]["loss"] == rows[1]["loss"]
    assert rows[0]["acc"] == rows[1]["acc"]
    assert _metrics(grouped, "eval")[0]["top1"] == \
        _metrics(single, "eval")[0]["top1"]


@pytest.mark.parametrize("spc", [1, 3, 8])
def test_steps_per_call_tracks_the_jax_trainer(scan_runs, spc):
    """The port's runs against the JAX `Trainer` at steps_per_call 3 (its
    lax.scan of 3 steps, then the 2-step remainder): every logged loss
    and the eval's top-k."""
    want, got = _steps(scan_runs["jax", 3]), _steps(scan_runs["port", spc])
    assert [s[:3] for s in got] == [s[:3] for s in want]
    np.testing.assert_allclose([s[3] for s in got], [s[3] for s in want],
                               rtol=1e-3)
    for k in ("top1", "top2"):
        assert _metrics(scan_runs["port", spc], "eval")[0][k] == \
            _metrics(scan_runs["jax", 3], "eval")[0][k]


@pytest.fixture(scope="module")
def fsim_runs(splits):
    tmp, paths = splits
    recipe = _recipe("sgn_fsim_sam", paths, "")
    assert recipe["optimizer"] == "SAM" and recipe["fsim_mode"] == 1
    os.makedirs(os.path.join(tmp, "fsim"))
    init = _initial_checkpoint(os.path.join(tmp, "fsim"),
                               recipe["model_args"])
    works = {}
    for who, run in (("jax", _jax_run), ("port", _port_run)):
        works[who] = os.path.join(tmp, f"fsim_{who}")
        run(_recipe("sgn_fsim_sam", paths, works[who]), init)
    return works


def test_fsim_sam_recipe_tracks_the_jax_trainer(fsim_runs):
    """SAM's steps with the fsim loss: every logged loss, the epoch's train
    metrics (loss, acc, fsim) and the eval's (top-k, then the aux
    metrics of the full batches: loss, acc, fsim), finite and within the
    bar of the JAX `Trainer`'s."""
    want, got = _steps(fsim_runs["jax"]), _steps(fsim_runs["port"])
    assert len(got) == 8 and [s[:3] for s in got] == [s[:3] for s in want]
    np.testing.assert_allclose([s[3] for s in got], [s[3] for s in want],
                               rtol=1e-3)
    for kind, keys in (("train", ("loss", "acc", "fsim")),
                       ("eval", ("top1", "top2", "loss", "acc", "fsim"))):
        (g,), (w,) = _metrics(fsim_runs["port"], kind), \
            _metrics(fsim_runs["jax"], kind)
        for k in keys:
            assert np.isfinite(g[k]), (kind, k)
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3,
                                       err_msg=f"{kind} {k}")
        assert 0 < g["fsim"] < g["loss"]
    with open(os.path.join(fsim_runs["port"], "log.txt")) as f:
        assert re.search(r"eval aux: loss [\d.]+, acc [\d.]+, fsim [\d.]+",
                         f.read())


def test_the_mmd_loss_still_names_its_item(splits):
    """The MMD loss of a model without the InfoGCN head (the fsim recipe's
    SGN) is refused, naming the known difference of ROADMAP Queue 3 (the
    JAX trainer's fallback prior is a jax.random draw)."""
    tmp, paths = splits
    recipe = _recipe("sgn_fsim_sam", paths, os.path.join(tmp, "mmd"),
                     mmd_lambda1=0.1)
    with pytest.raises(NotImplementedError,
                       match=r"mmd_lambda1.*InfoGCN head.*Queue 3"):
        _port_run(recipe)
