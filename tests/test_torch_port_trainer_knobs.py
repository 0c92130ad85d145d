"""The port trainer's run knobs against agcn_tpu's, on small AGCN runs on
the CPU: the TensorBoard event writer (`agcn_tpu_torch/utils/tb_writer.py`
byte for byte against the JAX package's, read back by TensorBoard's
`EventFileLoader`), the event scalars of a two-epoch run against the JAX
`Trainer`'s, async checkpoints, auto-resume (after JAX
tests/test_trainer.py:308-333), the work-dir guard, the profiler window
and a failed background write.

Tolerances: the event files bit for bit (time fixed); the event scalars
as tests/test_torch_port_trainer.py holds its runs (losses 1e-3 relative,
top-1 equal; both started from one checkpoint the JAX package saved), the
learning rates 1e-6 relative; checkpoints, resumed runs and runs with
async saves bit for bit against their references (the same CPU).
"""

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import yaml
from tensorboard.backend.event_processing.event_file_loader import \
    EventFileLoader

from agcn_tpu.utils import tb_writer as jax_tb
from agcn_tpu_torch.train import checkpoint as ckpt
from agcn_tpu_torch.train.trainer import Trainer
from agcn_tpu_torch.utils import tb_writer
from agcn_tpu_torch.utils.config import load_config
from tests.test_torch_port_trainer import (_evals, _initial_checkpoint,
                                           _recipe, _step_losses)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

SCALARS = [("train/loss", 1.25, 1), ("train/acc", 0.5, 1),
           ("train/lr", 0.05, 1), ("train/epoch", 0, 4),
           ("val/top1", 0.1875, 4), ("val/top5", 1.0, 2 ** 40),
           ("train/loss", -3.5e-7, 0), ("train/loss", float("inf"), 5)]


def events(directory):
    """(tag, step, value) of every scalar in the event files of
    `directory`, in file order (TensorBoard's reader, which hands a
    simple_value on as a scalar tensor)."""
    out = []
    for name in sorted(os.listdir(directory)):
        for event in EventFileLoader(os.path.join(directory, name)).Load():
            for value in event.summary.value:
                assert value.metadata.plugin_data.plugin_name == "scalars"
                (number,) = value.tensor.float_val
                out.append((value.tag, event.step, number))
    return out


@pytest.mark.parametrize("case", range(3))
def test_tb_writer_writes_the_jax_writers_bytes(tmp_path, monkeypatch,
                                                case):
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + 0.125 * case)
    scalars = SCALARS[case::3]
    files = []
    for name, module in (("port", tb_writer), ("jax", jax_tb)):
        writer = module.SummaryWriter(str(tmp_path / name))
        for tag, value, step in scalars:
            writer.add_scalar(tag, value, step)
        writer.close()
        (fname,) = os.listdir(tmp_path / name)
        with open(tmp_path / name / fname, "rb") as f:
            files.append((fname, f.read()))
    assert files[0] == files[1]
    assert files[0][0].startswith("events.out.tfevents.1700000000.")


def test_events_read_back_through_tensorboard(tmp_path):
    writer = tb_writer.SummaryWriter(str(tmp_path))
    for tag, value, step in SCALARS:
        writer.add_scalar(tag, value, step)
    writer.flush()
    got = events(str(tmp_path))
    writer.close()
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, _, s in SCALARS]
    np.testing.assert_array_equal(
        [v for _, _, v in got],
        np.float32([v for _, v, _ in SCALARS]))
    assert tb_writer.crc32c(b"123456789") == 0xE3069283


# -- a two-epoch run against the JAX Trainer --------------------------------

def _dataset(tmp, n, t):
    """n separable samples of t frames (tests/test_torch_port_trainer.py's
    data, smaller: the port's CPU steps take most of these tests' time)."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, 3, t, 25, 2)).astype(np.float32) * 0.5
    labels = (np.arange(n) % 4).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += 0.5 * label
    path = os.path.join(tmp, f"data{n}x{t}")
    np.save(path + ".npy", data)
    with open(path + ".pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels), f)
    return {"data_path": path + ".npy", "label_path": path + ".pkl",
            "window_size": t}


def _train(recipe, **over):
    """A port Trainer of `recipe` + `over`, its checkpoints' states
    recorded as they were saved: (trainer, {epoch: (model, optimizer)})."""
    path = os.path.join(os.path.dirname(recipe["work_dir"]),
                        os.path.basename(recipe["work_dir"]) + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(recipe, **over), f)
    trainer = Trainer(load_config(path))
    saved = {}
    save = trainer.save_checkpoint

    def recording_save(epoch):
        saved[epoch] = (
            {k: v.clone() for k, v in trainer.model.state_dict().items()},
            _clone(trainer.optimizer.state_dict()))
        save(epoch)

    trainer.save_checkpoint = recording_save
    return trainer, saved


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from agcn_tpu.train.trainer import Trainer as JaxTrainer
    from agcn_tpu.utils.config import Config as JaxConfig

    tmp = str(tmp_path_factory.mktemp("knob_runs"))
    feeder = _dataset(tmp, 8, 8)  # 2 steps an epoch at batch 4
    init = _initial_checkpoint(tmp)
    jax_recipe = _recipe(tmp, "jax", feeder)
    cfg = JaxConfig()
    # one save, at the end (the events do not depend on it)
    for key, value in dict(jax_recipe, weights=init, save_interval=2).items():
        setattr(cfg, key, value)
    JaxTrainer(cfg).start()
    port = dict(_recipe(tmp, "port", feeder), weights=init,
                async_checkpoint=True)
    trainer, saved = _train(port)
    trainer.start()
    return tmp, jax_recipe, port, saved, _dataset(tmp, 4, 8)


def test_event_scalars_match_the_jax_trainers(runs):
    _, jax_recipe, port, _, _ = runs
    for split in ("train", "val"):
        want = events(os.path.join(jax_recipe["work_dir"], "event", split))
        got = events(os.path.join(port["work_dir"], "event", split))
        assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
        for (tag, step, g), (_, _, w) in zip(got, want):
            if tag == "train/loss":
                np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=tag)
            elif tag == "train/lr":
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=tag)
            else:
                assert g == w, (tag, step, g, w)
    # 2 epochs x 2 logged steps of (loss, acc, lr), then train/epoch
    train = events(os.path.join(port["work_dir"], "event", "train"))
    assert [t for t, _, _ in train] == (
        ["train/loss", "train/acc", "train/lr"] * 2 + ["train/epoch"]) * 2
    assert [s for t, s, _ in train if t == "train/epoch"] == [2, 4]


def test_event_scalars_are_the_logs(runs):
    _, _, port, _, _ = runs
    work = port["work_dir"]
    train = events(os.path.join(work, "event", "train"))
    losses = [v for t, _, v in train if t == "train/loss"]
    np.testing.assert_allclose(losses, [s[2] for s in _step_losses(work)],
                               atol=5e-5)  # log.txt prints 4 decimals
    val = events(os.path.join(work, "event", "val"))
    evals = _evals(work)
    assert [v for t, _, v in val if t == "val/top1"] == pytest.approx(
        [e["top1"] for e in evals])
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    trains = [r for r in rows if r["kind"] == "train"]
    assert [s for t, s, _ in train if t == "train/epoch"] == \
        [r["steps"] for r in trains]
    np.testing.assert_allclose(
        [v for t, s, v in train if t == "train/loss" and s in (2, 4)],
        [r["loss"] for r in trains], rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 1])
def test_async_checkpoint_is_the_state_at_its_epochs_end(runs, epoch):
    """The checkpoint of epoch 1, written in the background while epoch 2
    trained, holds the state of epoch 1's end bit for bit."""
    _, _, port, saved, _ = runs
    state = torch.load(os.path.join(port["work_dir"], "checkpoints",
                                    f"epoch_{epoch + 1}.pt"),
                       weights_only=False)
    model, optimizer = saved[epoch]
    _assert_same(state["model"], model, "model")
    _assert_same(state["optimizer"], optimizer, "optimizer")
    assert state["epoch"] == epoch and state["step"] == 2 * (epoch + 1)
    assert not [n for n in os.listdir(os.path.dirname(
        os.path.join(port["work_dir"], "checkpoints", "x")))
        if n.endswith(".tmp")]


# -- auto-resume -------------------------------------------------------------

def test_auto_resume_continues_the_uninterrupted_run(runs):
    """After JAX test_trainer.py:308-333: a run of 2 epochs (checkpoints
    after each), then the same work dir with auto_resume and 3 epochs
    picks up the newest checkpoint (model, optimizer state and count) and
    continues at epoch 2; its epoch 2 and last checkpoint equal those of
    a 3-epoch run that was not interrupted."""
    tmp, _, _, _, feeder = runs
    base = _recipe(tmp, "auto", feeder)  # one step an epoch
    first, _ = _train(base, num_epoch=2)
    first.start()
    resumed, _ = _train(base, num_epoch=3, auto_resume=True)
    assert resumed.cfg.start_epoch == 2
    assert resumed.optimizer.count == first.optimizer.count == 2
    _assert_same(resumed.model.state_dict(), first.model.state_dict())
    _assert_same(resumed.optimizer.state_dict(),
                 first.optimizer.state_dict())
    resumed.start()
    straight, _ = _train(dict(base, work_dir=os.path.join(tmp, "straight")),
                         num_epoch=3)
    straight.start()
    want = [s for s in _step_losses(straight.work_dir) if s[0] >= 2]
    got = [s for s in _step_losses(base["work_dir"]) if s[0] >= 2]
    assert len(got) == 1 and got == want
    checkpoints = [torch.load(os.path.join(w, "checkpoints", "epoch_3.pt"),
                              weights_only=False)
                   for w in (base["work_dir"], straight.work_dir)]
    _assert_same(checkpoints[0]["model"], checkpoints[1]["model"])
    _assert_same(checkpoints[0]["optimizer"], checkpoints[1]["optimizer"])
    with open(os.path.join(base["work_dir"], "log.txt")) as f:
        log = f.read()
    assert (f"auto-resumed from {base['work_dir']}/checkpoints/epoch_2.pt "
            "(continuing at epoch 2)") in log


def test_auto_resume_skips_what_fails_to_load(runs):
    tmp, _, _, _, feeder = runs
    base = dict(_recipe(tmp, "auto_bad", feeder), num_epoch=1)
    first, _ = _train(base)
    first.start()
    with open(os.path.join(base["work_dir"], "checkpoints", "epoch_7.pt"),
              "wb") as f:
        f.write(b"not a checkpoint")
    again, _ = _train(base, auto_resume=True)
    assert again.cfg.start_epoch == 0 and again.optimizer.count == 0
    with open(os.path.join(base["work_dir"], "log.txt")) as f:
        assert "auto-resume skipped (" in f.read()


def test_work_dir_guard_lets_auto_resume_through(runs):
    tmp, _, _, _, feeder = runs
    base = dict(_recipe(tmp, "guard", feeder), num_epoch=1)
    _train(base)  # writes log.txt
    with pytest.raises(RuntimeError, match="already contains a run"):
        _train(base)
    fresh, _ = _train(base, auto_resume=True)  # no checkpoint yet
    assert fresh.cfg.start_epoch == 0 and fresh.optimizer.count == 0


# -- the profiler window -----------------------------------------------------

@pytest.mark.parametrize("batch,epochs,traced", [(1, 1, 6), (2, 2, 2)])
def test_profiler_writes_a_chrome_trace(runs, batch, epochs, traced):
    """Steps 2-7 of the first epoch (8 steps at batch 1), or steps 2-3 of
    an epoch of 4 (the window closed at the epoch's end): one Chrome trace
    in work_dir/trace holding the steps' convolutions, and the log line;
    a second epoch is not traced."""
    tmp, _, _, _, _ = runs
    base = dict(_recipe(tmp, f"profile{batch}", _dataset(tmp, 8, 8)),
                batch_size=batch, num_epoch=epochs, profiler=True)
    trainer, _ = _train(base)
    trainer.start()
    trace_dir = os.path.join(base["work_dir"], "trace")
    assert os.listdir(trace_dir) == ["epoch0_steps2-7.pt.trace.json"]
    with open(os.path.join(trace_dir, os.listdir(trace_dir)[0])) as f:
        trace = json.load(f)
    names = [e.get("name", "") for e in trace["traceEvents"]]
    # each step: 10 temporal convolutions forward
    assert sum(n == "aten::convolution" for n in names) >= 10 * traced
    with open(os.path.join(base["work_dir"], "log.txt")) as f:
        log = f.read()
    assert log.count(f"profiler trace written to {trace_dir}") == 1


# -- a failed background write -----------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4.0))


@pytest.mark.parametrize("surfaces_at", ["wait", "next_save"])
def test_a_failed_async_write_raises(tmp_path, monkeypatch, surfaces_at):
    def refuse(obj, path):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(torch, "save", refuse)
    path = str(tmp_path / "epoch_1")
    assert ckpt.save_checkpoint(path, _Tiny(), {}, 1, 0, 1,
                                async_save=True) == path + ".pt"
    with pytest.raises(RuntimeError, match="disk full"):
        if surfaces_at == "wait":
            ckpt.wait_for_checkpoints()
        else:
            ckpt.save_checkpoint(str(tmp_path / "epoch_2"), _Tiny(), {}, 2,
                                 1, 1, async_save=True)
    ckpt.wait_for_checkpoints()  # reported once
    assert not os.listdir(tmp_path)


def test_a_failed_async_write_fails_the_run(runs, monkeypatch):
    tmp, _, _, _, feeder = runs
    base = dict(_recipe(tmp, "failing", feeder), num_epoch=1,
                async_checkpoint=True)
    trainer, _ = _train(base)
    monkeypatch.setattr(torch, "save", lambda obj, path: 1 / 0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        trainer.start()
