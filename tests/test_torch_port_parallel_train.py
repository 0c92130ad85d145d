"""Data-parallel and edge-partitioned training through the port's entry
point on gloo ranks (tests/torch_port_dist.py), against one process.

A small AGCN recipe (no dropout, T 16, 32 samples, 4 classes, as
tests/test_multiprocess.py; one epoch of two steps) runs as one process
at a global batch of 16, as 2 data ranks at 8 each, and as 4 ranks on a
(data 2, edge 2) mesh (`mesh_edge: 2`): the per-step losses and the eval
scores of every sample agree at JAX's bar for the losses (rtol 2e-3,
atol 2e-4, tests/test_multiprocess.py:109), rank 0 alone writes the work
dir, and `--phase test` on the DDP checkpoint at 2 ranks with a test
batch of 3 (which neither the set nor the shards divide) reproduces the
run's final scores. One SAM step with PA frozen (`only_train_part`) on
2 data ranks gives the one-process step's loss and the scores of the
model it leaves (SAM perturbs by the data-reduced gradient), and PA,
whose gradient is zeroed, takes only the weight decay on both. Then configs/ntu60_xview/train_joint_mesh_edge.yaml,
with only its data paths, sizes and device replaced, trains an epoch on
4 ranks. The one-process trainer is held against JAX by
tests/test_torch_port_trainer.py.
"""

import json
import os
import pickle

import numpy as np
import pytest
import yaml

from agcn_tpu_torch.train.checkpoint import load_checkpoint
from chip_smoke import read_events
from tests.conftest import REPO_ROOT
from tests.torch_port_dist import join, start
from tests.torch_port_threads import one_torch_thread  # noqa: F401

N, NUM_CLASS = 32, 4


def _write_data(path, n=N, num_class=NUM_CLASS):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, 3, 16, 25, 2)).astype(np.float32) * 0.1
    labels = (np.arange(n) % num_class).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += label % 4
    path.mkdir(exist_ok=True)
    np.save(path / "data.npy", data)
    with open(path / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels), f)
    return {"data_path": str(path / "data.npy"),
            "label_path": str(path / "label.pkl")}


def _config(tmp, name, feeder, **kw):
    cfg = dict(
        work_dir=str(tmp / name), model="agcn",
        model_args={"num_class": NUM_CLASS, "graph": "ntu_rgb_d"},
        train_feeder_args=feeder, test_feeder_args=feeder,
        num_epoch=1, save_score=True, base_lr=0.05, log_interval=1,
        device="cpu", **kw)
    path = tmp / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return ["--config", str(path)]


def _mesh_edge_recipe(tmp):
    """train_joint_mesh_edge.yaml with only its data paths, sizes and
    device replaced: 4 samples of 60 classes, 2 a data rank."""
    with open(os.path.join(REPO_ROOT, "configs", "ntu60_xview",
                           "train_joint_mesh_edge.yaml")) as f:
        recipe = yaml.safe_load(f)
    assert recipe["mesh_edge"] == 2 and "mesh_data" not in recipe
    feeder = _write_data(tmp / "data60", n=4, num_class=60)
    recipe.update(
        work_dir=str(tmp / "mesh_edge"), device="cpu", batch_size=2,
        test_batch_size=2, num_epoch=1,
        train_feeder_args=dict(recipe["train_feeder_args"], **feeder),
        test_feeder_args=dict(recipe["test_feeder_args"], **feeder))
    path = tmp / "mesh_edge.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return ["--config", str(path)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The work dirs of every run: one spawn of four rank processes for the
    (data 2, edge 2) run, the mesh-edge recipe, the 2-rank DDP run, the
    2-rank SAM step and `--phase test` on the DDP checkpoint, and, while
    they run, the one-process runs in this one (no launcher)."""
    from agcn_tpu_torch.main import main

    tmp = tmp_path_factory.mktemp("parallel_train")
    feeder = dict(_write_data(tmp / "data"), window_size=16)
    # one SAM step of 16 samples, PA frozen
    sam_feeder = dict(_write_data(tmp / "data16", n=16), window_size=16)
    sam = dict(test_batch_size=16, optimizer="SAM", sam_rho=0.05,
               only_train_part=True, only_train_epoch=1)
    jobs = [
        ("edge", 4, _config(tmp, "edge", feeder, batch_size=8,
                            test_batch_size=8, mesh_edge=2)),
        ("mesh_edge", 4, _mesh_edge_recipe(tmp)),
        ("ddp", 2, _config(tmp, "ddp", feeder, batch_size=8,
                           test_batch_size=8, world_size=2, ddp=True)),
        ("sam", 2, _config(tmp, "sam", sam_feeder, batch_size=8, **sam)),
        # a test batch of 3, which neither the set nor the shards divide
        ("ddp_test", 2, _config(
            tmp, "ddp_test", feeder, batch_size=8, test_batch_size=3,
            phase="test", weights=str(tmp / "ddp" / "checkpoints" /
                                      "epoch_1.pt")))]
    procs = start([{"job": "main", "world": world, "argv": argv}
                   for _, world, argv in jobs], tmp)
    with pytest.MonkeyPatch.context() as mp:
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            mp.delenv(key, raising=False)
        main(_config(tmp, "single", feeder, batch_size=16,
                     test_batch_size=16))
        main(_config(tmp, "sam_single", sam_feeder, batch_size=16, **sam))
    join(procs)
    return {name: str(tmp / name)
            for name in ("single", "edge", "mesh_edge", "ddp", "ddp_test",
                         "sam", "sam_single")}


def _step_losses(work_dir):
    """(step, loss) of each logged step, from the event file (fp32)."""
    directory = os.path.join(work_dir, "event", "train")
    assert len(os.listdir(directory)) == 1
    return [(step, value) for tag, step, value in read_events(directory)
            if tag == "train/loss"]


def _scores(work_dir, name, n=N):
    with open(os.path.join(work_dir, "score", name), "rb") as f:
        d = pickle.load(f)
    assert sorted(d) == sorted(f"s{i}" for i in range(n))
    return np.stack([d[f"s{i}"] for i in range(n)])


def _metrics(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_ddp_and_edge_mesh_reproduce_one_process(runs):
    want = _step_losses(runs["single"])
    assert [s for s, _ in want] == [1, 2]
    for work in (runs["ddp"], runs["edge"]):
        got = _step_losses(work)
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=2e-3, atol=2e-4, err_msg=work)
        np.testing.assert_allclose(_scores(work, "epoch1_val.pkl"),
                                   _scores(runs["single"], "epoch1_val.pkl"),
                                   rtol=2e-3, atol=2e-4, err_msg=work)
        # rank 0 alone wrote the work dir: each line once
        with open(os.path.join(work, "log.txt")) as f:
            log = f.read()
        assert log.count("Model agcn built") == 1
        assert [(m["kind"], m["epoch"]) for m in _metrics(work)] == [
            ("train", 0), ("eval", 0)]
        assert os.listdir(os.path.join(work, "checkpoints")) == ["epoch_1.pt"]
        assert len(os.listdir(os.path.join(work, "event", "val"))) == 1
    # --phase test on the DDP checkpoint, 2 ranks, a test batch of 3
    test = runs["ddp_test"]
    np.testing.assert_allclose(_scores(test, "epoch1_val.pkl"),
                               _scores(runs["ddp"], "epoch1_val.pkl"),
                               atol=1e-4)
    with open(os.path.join(test, "right.txt")) as f:
        right = len(f.readlines())
    with open(os.path.join(test, "wrong.txt")) as f:
        assert right + len(f.readlines()) == N
    # one SAM step, PA frozen, on 2 data ranks against one process
    np.testing.assert_allclose(_step_losses(runs["sam"]),
                               _step_losses(runs["sam_single"]),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(_scores(runs["sam"], "epoch1_val.pkl", 16),
                               _scores(runs["sam_single"], "epoch1_val.pkl",
                                       16), rtol=2e-3, atol=2e-4)
    weights = [load_checkpoint(os.path.join(runs[name], "checkpoints",
                                            "epoch_1.pt"))["model"]
               for name in ("sam", "sam_single")]
    # PA (initialized to 1e-6) took only the weight decay: its gradient
    # was zeroed on every rank
    for w in weights:
        np.testing.assert_allclose(w["l1.gcn1.PA"].numpy(), 1e-6, rtol=1e-4)


def test_mesh_edge_recipe_trains_an_epoch_on_four_ranks(runs):
    work = runs["mesh_edge"]
    metrics = _metrics(work)
    assert [(m["kind"], m["epoch"]) for m in metrics] == [("train", 0),
                                                         ("eval", 0)]
    # 4 samples over 2 data ranks at 2 a rank: one step
    assert metrics[0]["steps"] == 1 and np.isfinite(metrics[0]["loss"])
    assert os.path.exists(os.path.join(work, "checkpoints", "epoch_1.pt"))
    with open(os.path.join(work, "log.txt")) as f:
        assert "4 ranks as Mesh(data=2, edge=2)" in f.read()
