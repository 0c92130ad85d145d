"""The port's entry point (`agcn_tpu_torch.main`, `--device cpu`) against
agcn_tpu's `Trainer` on one 16-sample dataset with the same seed, both
started from one checkpoint the JAX package saved (npz, loaded with
`--weights`): the per-step losses of two epochs, the eval top-1 of each
epoch, `--phase test` on the port's checkpoint, and resuming from the
epoch-1 checkpoint.

Tolerance: losses 1e-3 relative (eight fp32 SGD steps on the same batches
in the same order; the weights are conditioned as in
tests/test_torch_port_train_step.py so that no ReLU input sits at the
kink); top-1 equal.
"""

import json
import os
import pickle
import re

import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu.train.trainer import Trainer as JaxTrainer
from agcn_tpu.utils.config import Config as JaxConfig
from agcn_tpu.utils.torch_import import agcn_variables_from_torch
from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.main import main
from agcn_tpu_torch.models import AGCN
from tests.test_torch_port_train_step import _randomize
from tests.torch_port_threads import one_torch_thread  # noqa: F401

N, T, NUM_CLASS = 16, 16, 4
_STEP = re.compile(r"epoch (\d+) step (\d+)/\d+ loss ([-\d.]+)")


def _dataset(tmp):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, 3, T, 25, 2)).astype(np.float32) * 0.5
    labels = (np.arange(N) % NUM_CLASS).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += 0.5 * label  # separable classes
    np.save(os.path.join(tmp, "data.npy"), data)
    with open(os.path.join(tmp, "label.pkl"), "wb") as f:
        pickle.dump(([f"s{i}" for i in range(N)], labels), f)
    feeder = {"data_path": os.path.join(tmp, "data.npy"),
              "label_path": os.path.join(tmp, "label.pkl"),
              "window_size": T}
    return feeder


def _recipe(tmp, work, feeder):
    return {"work_dir": os.path.join(tmp, work), "model": "agcn",
            "model_args": {"num_class": NUM_CLASS, "graph": "ntu_rgb_d"},
            "train_feeder_args": feeder, "test_feeder_args": feeder,
            "batch_size": 4, "test_batch_size": 8, "num_epoch": 2,
            "eval_interval": 1, "save_interval": 1, "base_lr": 0.05,
            "log_interval": 1, "seed": 7, "save_score": True,
            "print_log": False, "mesh_data": 1, "num_worker": 0,
            "device": "cpu"}


def _initial_checkpoint(tmp):
    """A checkpoint written by the JAX package: the port's seeded init in
    the JAX layout, conditioned BN affines and random BN statistics."""
    model = AGCN(num_class=NUM_CLASS, adj=build_adjacency("ntu_rgb_d"),
                 device="cpu", generator=torch.Generator().manual_seed(3))
    variables = _randomize(agcn_variables_from_torch(model.state_dict()))
    path = os.path.join(tmp, "init")
    save_checkpoint(path, variables, use_orbax=False)
    return path


def _step_losses(work):
    with open(os.path.join(work, "log.txt")) as f:
        return [(int(m[1]), int(m[2]), float(m[3]))
                for m in _STEP.finditer(f.read())]


def _evals(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["kind"] == "eval"]


def _port_run(tmp, recipe, name, *flags):
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    main(["--config", path, *flags])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainers"))
    feeder = _dataset(tmp)
    init = _initial_checkpoint(tmp)
    jax_recipe = _recipe(tmp, "jax", feeder)
    cfg = JaxConfig()
    for key, value in dict(jax_recipe, weights=init).items():
        setattr(cfg, key, value)
    JaxTrainer(cfg).start()
    port = _recipe(tmp, "port", feeder)
    _port_run(tmp, port, "port", "--weights", init)
    return tmp, jax_recipe, port, feeder


def test_port_trainer_tracks_the_jax_trainer(runs):
    tmp, jax_recipe, port, _ = runs
    want = _step_losses(jax_recipe["work_dir"])
    got = _step_losses(port["work_dir"])
    assert [s[:2] for s in got] == [s[:2] for s in want]
    assert len(got) == 8  # 2 epochs x 4 steps
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-3)
    assert [e["top1"] for e in _evals(port["work_dir"])] == \
        [e["top1"] for e in _evals(jax_recipe["work_dir"])]


def test_test_phase_reproduces_the_runs_top1(runs):
    tmp, _, port, _ = runs
    work = os.path.join(tmp, "port_test")
    _port_run(tmp, dict(port, work_dir=work), "port_test", "--phase",
              "test", "--weights",
              os.path.join(port["work_dir"], "checkpoints", "epoch_2"))
    top1 = _evals(work)[-1]["top1"]
    assert top1 == _evals(port["work_dir"])[-1]["top1"]
    lines = {}
    for name in ("right", "wrong"):
        with open(os.path.join(work, f"{name}.txt")) as f:
            lines[name] = len(f.readlines())
    assert lines["right"] == round(top1 * N)
    assert lines["right"] + lines["wrong"] == N


def test_resume_from_epoch_one_gives_the_same_second_epoch(runs):
    tmp, _, port, _ = runs
    work = os.path.join(tmp, "port_resume")
    _port_run(tmp, dict(port, work_dir=work), "port_resume", "--weights",
              os.path.join(port["work_dir"], "checkpoints", "epoch_1"),
              "--start-epoch", "1")
    want = [s for s in _step_losses(port["work_dir"]) if s[0] == 1]
    got = _step_losses(work)
    assert [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-6)
    assert _evals(work)[-1]["top1"] == _evals(port["work_dir"])[-1]["top1"]
