"""The port's trainer on a shrunk AAGCN-transformer recipe against the JAX
package's `Trainer` on the CPU (`agcn_tpu_torch.main --device cpu`), both
from one npz the JAX package saved: AdamW with the onecycle schedule and
the port's resume of its moments; the `llrd_factor` rule with SGD-LLRD;
and a resume at dropout > 0, whose masks are the uninterrupted run's.

The recipe: `train_joint_aagcn_transformer.yaml`'s model ('dual',
cross_fusion, pre-norm) at backbone 16, 2 encoder layers of 4 heads, T =
16, dropout 0 against JAX (the two frameworks' dropout masks cannot
match), 16 samples, batch 4.

Tolerance: every step's loss 1e-3 relative (fp32 steps on the same
batches in the same order; BN conditioned as in
tests/test_torch_port_transformer.py), top-1 equal; a resumed epoch
equals the uninterrupted one's to 1e-6.
"""

import json
import pickle
import re

import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu.train.trainer import Trainer as JaxTrainer
from agcn_tpu.utils.config import Config as JaxConfig
from agcn_tpu_torch.main import main as port_main
from agcn_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_port_transformer import SMALL, _variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401

_STEP = re.compile(r"epoch (\d+) step (\d+)/\d+ loss ([-\d.]+)")
N, T, CLASSES = 16, 16, 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The data, the model's arguments and the JAX initial weights, shared
    by every run of this file."""
    tmp = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, 3, T, 25, 2)).astype(np.float32) * 0.5
    labels = (np.arange(N) % CLASSES).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += 0.5 * label
    np.save(tmp / "data.npy", data)
    with open(tmp / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(N)], labels), f)
    feeder = {"data_path": str(tmp / "data.npy"),
              "label_path": str(tmp / "label.pkl"), "window_size": T}
    args = dict(SMALL, num_class=CLASSES, graph="ntu_rgb_d",
                mode="dual", model_layers=101, cross_fusion=True,
                dropout=0.0)
    # the JAX trainer sizes the tables from a T = 16 input, as the data
    variables = _variables(t=T, seed=3, condition=True,
                           **{k: v for k, v in args.items()
                              if k != "graph"})
    init = str(tmp / "init")
    save_checkpoint(init, variables, use_orbax=False)
    return feeder, args, init


def _recipe(tmp_path, work, feeder, args, **over):
    return dict({"work_dir": str(tmp_path / work),
                 "model": "aagcn_transformer", "model_args": args,
                 "train_feeder_args": feeder, "test_feeder_args": feeder,
                 "batch_size": 4, "test_batch_size": 8, "num_epoch": 2,
                 "eval_interval": 1, "save_interval": 1, "log_interval": 1,
                 "seed": 7, "print_log": False, "mesh_data": 1,
                 "num_worker": 0, "device": "cpu"}, **over)


def _steps(path):
    with open(path / "log.txt") as f:
        return [(int(m[1]), int(m[2]), float(m[3]))
                for m in _STEP.finditer(f.read())]


def _evals(path):
    with open(path / "metrics.jsonl") as f:
        return [r["top1"] for r in map(json.loads, f) if r["kind"] == "eval"]


def _run_port(tmp_path, work, feeder, args, *extra, **over):
    path = tmp_path / f"{work}.yaml"
    path.write_text(yaml.safe_dump(_recipe(tmp_path, work, feeder, args,
                                           **over)))
    port_main(["--config", str(path), *extra])


def _run_jax(tmp_path, work, feeder, args, init, **over):
    cfg = JaxConfig()
    for key, value in dict(_recipe(tmp_path, work, feeder, args, **over),
                           weights=init).items():
        setattr(cfg, key, value)
    JaxTrainer(cfg).start()


def test_port_trainer_tracks_the_jax_trainer(tmp_path, files):
    """`agcn_tpu_torch.main --device cpu` on the shrunk recipe with AdamW
    and onecycle against the JAX Trainer, both from one npz the JAX
    package saved: every step's loss over two epochs and each epoch's
    top-1. Then the port resumes epoch 2 from its epoch-1 checkpoint: the
    optimizer's count and moments come back, and epoch 2's losses are the
    run's."""
    feeder, args, init = files
    over = dict(optimizer="AdamW", scheduler="onecyclelr", base_lr=0.002,
                warm_up_epoch=1, initial_lr=1e-4, final_lr=1e-6,
                weight_decay=1e-4)
    _run_jax(tmp_path, "jax", feeder, args, init, **over)
    _run_port(tmp_path, "port", feeder, args, "--weights", init, **over)
    want, got = _steps(tmp_path / "jax"), _steps(tmp_path / "port")
    assert len(got) == 8 and [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-3)
    assert _evals(tmp_path / "port") == _evals(tmp_path / "jax")

    ckpt = tmp_path / "port" / "checkpoints" / "epoch_1.pt"
    saved = tckpt.load_checkpoint(str(ckpt))["optimizer"]
    assert saved["count"] == 4
    _run_port(tmp_path, "resume", feeder, args, "--weights", str(ckpt),
              "--start-epoch", "1", **over)
    np.testing.assert_allclose([s[2] for s in _steps(tmp_path / "resume")],
                               [s[2] for s in got[4:]], rtol=1e-6)
    final = tckpt.load_checkpoint(
        str(tmp_path / "resume" / "checkpoints" / "epoch_2.pt"))
    direct = tckpt.load_checkpoint(
        str(tmp_path / "port" / "checkpoints" / "epoch_2.pt"))
    assert final["optimizer"]["count"] == direct["optimizer"]["count"] == 8
    states = final["optimizer"]["opt"]["state"]
    assert len(states) > 50
    for i, st in states.items():
        assert set(st) == {"step", "mu", "nu"}
        for k, v in st.items():
            other = direct["optimizer"]["opt"]["state"][i][k]
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(v, other, rtol=1e-5, atol=1e-7)
            else:
                assert v == other


def test_llrd_factor_needs_an_llrd_optimizer(tmp_path, files):
    """`llrd_factor` scales nothing unless the optimizer's name says LLRD
    (agcn_tpu trainer.py:305-306): SGD with factor 0.9 trains exactly as
    SGD with factor 1, and SGD-LLRD with 0.9 does not, but tracks the JAX
    Trainer's SGD-LLRD run step by step."""
    feeder, args, init = files
    runs = {"sgd_09": dict(optimizer="SGD", llrd_factor=0.9),
            "sgd_1": dict(optimizer="SGD", llrd_factor=1.0),
            "sgd_llrd_09": dict(optimizer="SGD-LLRD", llrd_factor=0.9)}
    for work, over in runs.items():
        _run_port(tmp_path, work, feeder, args, "--weights", init,
                  num_epoch=1, base_lr=0.05, **over)
    states = {w: tckpt.load_checkpoint(
        str(tmp_path / w / "checkpoints" / "epoch_1.pt"))["model"]
        for w in runs}
    for name, v in states["sgd_1"].items():
        assert torch.equal(states["sgd_09"][name], v), name
    name = "temporal_encoder.layer1.linear1.weight"
    assert not torch.equal(states["sgd_llrd_09"][name],
                           states["sgd_1"][name])
    _run_jax(tmp_path, "jax", feeder, args, init, num_epoch=1, base_lr=0.05,
             **runs["sgd_llrd_09"])
    want, got = _steps(tmp_path / "jax"), _steps(tmp_path / "sgd_llrd_09")
    assert len(got) == 4 and [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-3)
    assert _evals(tmp_path / "sgd_llrd_09") == _evals(tmp_path / "jax")


def test_resume_draws_the_uninterrupted_dropout_masks(tmp_path, files):
    """At the recipe's dropout (encoders and `drop_out`), epoch 2 resumed
    from the epoch-1 checkpoint draws the masks of the run that went on:
    each step reseeds the model's dropout generator from its seed and the
    update count, as the JAX step folds the step into its key."""
    feeder, args, init = files
    args = dict(args, dropout=0.1, drop_out=0.1)
    over = dict(optimizer="AdamW", base_lr=0.002, weight_decay=1e-4)
    _run_port(tmp_path, "whole", feeder, args, "--weights", init, **over)
    _run_port(tmp_path, "resumed", feeder, args, "--weights",
              str(tmp_path / "whole" / "checkpoints" / "epoch_1.pt"),
              "--start-epoch", "1", **over)
    whole = [s[2] for s in _steps(tmp_path / "whole")]
    np.testing.assert_allclose([s[2] for s in _steps(tmp_path / "resumed")],
                               whole[4:], rtol=1e-6)
    # the masks are live: without dropout the same run's losses differ
    _run_port(tmp_path, "nodrop", feeder, dict(args, dropout=0.0,
                                               drop_out=0.0),
              "--weights", init, **over)
    assert [s[2] for s in _steps(tmp_path / "nodrop")] != whole
