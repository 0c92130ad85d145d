"""The port's serving engine on the CPU: the equivalences of
tests/test_serving.py (batched vs single stream, padding invariance,
pipelined vs sync, vectorized prep) for agcn_tpu_torch, and the port's
server answering as the JAX server does for the same frames and weights.
"""

import jax
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.infer.serving import BatchedStreamServer as JaxServer
from agcn_tpu.models.agcn import AGCN as JaxAGCN
from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.infer import (ActionRecognition, BatchedStreamServer,
                                  filter_logits)
from agcn_tpu_torch.infer.cli import main as cli_main
from agcn_tpu_torch.models import AGCN
from agcn_tpu_torch.utils.weights import agcn_state_dict_from_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7


def _frames(seed, n_frames=24, v=25):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 1, v, 3)).astype(np.float32) * 0.2
            for _ in range(n_frames)]


@pytest.fixture(scope="module")
def models():
    """The JAX model and variables, and the port's model with the same
    weights (formulation='pallas': the kernel's plain version on CPU)."""
    adj = jax_build_adjacency("ntu_rgb_d")
    jmodel = JaxAGCN(num_class=NUM_CLASS, adj=adj)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            np.zeros((1, 3, 32, 25, 2), np.float32),
                            train=False)
    tmodel = AGCN(num_class=NUM_CLASS, adj=build_adjacency("ntu_rgb_d"),
                  formulation="pallas", device="cpu")
    tmodel.load_state_dict(agcn_state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables))), strict=True)
    return jmodel, variables, tmodel.eval()


def test_batched_matches_single_stream(models):
    model = models[2]
    kwargs = dict(max_seq_length=32, moving_avg=2)
    server = BatchedStreamServer(model, max_streams=4, **kwargs)
    singles = {}
    for seed in (0, 1, 2):
        sid = server.add_stream()
        single = ActionRecognition(model, **kwargs)
        for f in _frames(seed):
            server.append_frame(sid, f)
            single.append_frame(f)
        singles[sid] = single
    batched = server.predict()
    assert set(batched) == set(singles)
    for sid, single in singles.items():
        label_s, probs_s = single.predict()
        label_b, probs_b = batched[sid]
        assert label_b == label_s
        np.testing.assert_allclose(probs_b, probs_s, atol=1e-5, rtol=1e-5)


def test_padding_invariance(models):
    model = models[2]
    s1 = BatchedStreamServer(model, max_streams=4, max_seq_length=32)
    sid = s1.add_stream()
    for f in _frames(5):
        s1.append_frame(sid, f)
    alone = s1.predict()[sid]

    s2 = BatchedStreamServer(model, max_streams=4, max_seq_length=32)
    sid2 = s2.add_stream()
    others = [s2.add_stream() for _ in range(3)]
    for f in _frames(5):
        s2.append_frame(sid2, f)
    for i, o in enumerate(others):
        for f in _frames(10 + i):
            s2.append_frame(o, f)
    crowded = s2.predict()[sid2]
    assert alone[0] == crowded[0]
    np.testing.assert_allclose(alone[1], crowded[1], atol=1e-5, rtol=1e-5)


def test_capacity_and_lifecycle(models):
    server = BatchedStreamServer(models[2], max_streams=2,
                                 max_seq_length=32)
    a = server.add_stream()
    b = server.add_stream()
    with pytest.raises(RuntimeError, match="capacity"):
        server.add_stream()
    server.remove_stream(a)
    c = server.add_stream()
    assert c not in (a, b)  # ids are never reused
    assert len(server.predict()) == 2  # empty buffers still serve
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedStreamServer(models[2], max_streams=2, kind="sgn")


def test_batched_vectorized_preprocessing_matches(models):
    """>4 live streams route host prep through the whole-batch
    vectorized path; answers must equal the single-stream path's."""
    model = models[2]
    server = BatchedStreamServer(model, max_streams=6, max_seq_length=32)
    singles = {}
    for seed in range(6):
        sid = server.add_stream()
        single = ActionRecognition(model, max_seq_length=32)
        for f in _frames(seed):
            server.append_frame(sid, f)
            single.append_frame(f)
        singles[sid] = single
    batched = server.predict()
    for sid, single in singles.items():
        _, probs_s = single.predict()
        np.testing.assert_allclose(batched[sid][1], probs_s,
                                   atol=1e-5, rtol=1e-5)


def test_batched_vectorized_energy_selection(models):
    model = models[2]
    server = BatchedStreamServer(model, max_streams=6, max_seq_length=32,
                                 max_person=4)
    single = ActionRecognition(model, max_seq_length=32, max_person=4)
    rng = np.random.default_rng(9)
    for _ in range(6):
        server.add_stream()
    for _ in range(32):
        # body 0 quiet, body 1 empty, body 2 loud, body 3 medium
        f = np.zeros((4, 1, 25, 3), np.float32)
        f[0] = rng.standard_normal((1, 25, 3)) * 0.01
        f[2] = rng.standard_normal((1, 25, 3)) * 1.0
        f[3] = rng.standard_normal((1, 25, 3)) * 0.1
        for sid in range(6):
            server.append_frame(sid, f)
        single.append_frame(f)
    batched = server.predict()
    label_s, probs_s = single.predict()
    for sid in range(6):
        assert batched[sid][0] == label_s
        np.testing.assert_allclose(batched[sid][1], probs_s,
                                   atol=1e-5, rtol=1e-5)


def test_pipelined_matches_sync(models):
    model = models[2]
    kwargs = dict(max_seq_length=32, moving_avg=2)
    sync = BatchedStreamServer(model, max_streams=3, **kwargs)
    pipe = BatchedStreamServer(model, max_streams=3, **kwargs)
    assert pipe.predict_async() is None  # no streams -> nothing enqueued
    assert pipe.flush() is None
    for _ in range(3):
        sync.add_stream()
        pipe.add_stream()
    frames = {sid: _frames(sid, n_frames=40) for sid in range(3)}
    want, got = [], []
    for t in range(8, 41, 8):
        for sid in range(3):
            for f in frames[sid][t - 8:t]:
                sync.append_frame(sid, f)
                pipe.append_frame(sid, f)
        want.append(sync.predict())
        r = pipe.predict_async()
        if r is not None:
            got.append(r)
    tail = pipe.flush()
    assert tail is not None
    got.append(tail)
    assert pipe.flush() is None
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for sid in w:
            assert g[sid][0] == w[sid][0]
            np.testing.assert_allclose(g[sid][1], w[sid][1],
                                       atol=1e-5, rtol=1e-5)


def test_predict_rejects_inflight_pipeline(models):
    server = BatchedStreamServer(models[2], max_streams=2,
                                 max_seq_length=32)
    server.add_stream()
    for f in _frames(0):
        server.append_frame(0, f)
    server.predict_async()
    with pytest.raises(RuntimeError, match="flush"):
        server.predict()
    assert server.flush() is not None
    server.predict()


@pytest.mark.parametrize("streams", [3, 6])  # per-stream / vectorized prep
def test_port_server_answers_as_jax_server(models, streams):
    """Same frames, same weights: the same labels, probabilities within
    1e-4."""
    jmodel, variables, tmodel = models
    kwargs = dict(max_seq_length=32, moving_avg=2,
                  allowed_classes=[0, 2, 3, 5])
    jserver = JaxServer(jmodel, variables, max_streams=streams,
                        kind="dense", **kwargs)
    tserver = BatchedStreamServer(tmodel, max_streams=streams, **kwargs)
    for seed in range(streams):
        assert jserver.add_stream() == tserver.add_stream()
        for f in _frames(seed + 20, n_frames=40):
            jserver.append_frame(seed, f)
            tserver.append_frame(seed, f)
    want, got = jserver.predict(), tserver.predict()
    assert set(want) == set(got) == set(range(streams))
    for sid in want:
        assert got[sid][0] == want[sid][0]
        np.testing.assert_allclose(got[sid][1], want[sid][1], atol=1e-4)
        assert got[sid][1][[1, 4, 6]].sum() == 0.0  # filtered classes


def test_filter_logits():
    logits = np.arange(5, dtype=np.float32)
    assert filter_logits(logits, None) is logits
    np.testing.assert_array_equal(
        np.isfinite(filter_logits(logits, [1, 3])),
        [False, True, False, True, False])


def test_cli_serves_a_directory_on_cpu(models, tmp_path, capsys):
    """python -m agcn_tpu_torch.infer --serve on CPU, weights from a .pt
    state dict and the config's model args."""
    rec = tmp_path / "rec"
    rec.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        np.save(rec / f"cam{i}.npy",
                rng.standard_normal((3, 20, 25, 2)).astype(np.float32))
    torch.save(models[2].state_dict(), tmp_path / "w.pt")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("model: agcn\nmodel_args: {num_class: 7, "
                   "formulation: pallas}\n")
    cli_main(["--config", str(cfg), "--weights", str(tmp_path / "w.pt"),
              "--input", str(rec), "--serve", "3", "--pipeline",
              "--timing", "--interval", "10", "--max-frame", "32",
              "--device", "cpu", "--out-folder", str(tmp_path / "out")])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[cam") for ln in lines) == 3 * 2
    assert sum(ln.startswith("tick:") for ln in lines) == 2
    assert len((tmp_path / "out" / "results_cam0.txt").read_text()
               .splitlines()) == 2
    with pytest.raises(SystemExit):  # --serve N is required
        cli_main(["--config", str(cfg), "--weights", str(tmp_path / "w.pt"),
                  "--input", str(rec), "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--weights", "--weights-dir"])
def test_cli_serves_a_trainer_checkpoint_on_cpu(models, tmp_path, capsys,
                                                flag):
    """The serving CLI on the port trainer's own checkpoint file (the
    `kind` dict of train/checkpoint.save_checkpoint), named directly or
    found under the trainer's work dir; it answers as the same weights
    given as a bare state dict do."""
    from agcn_tpu_torch.train.checkpoint import save_checkpoint

    rec = tmp_path / "rec"
    rec.mkdir()
    rng = np.random.default_rng(1)
    np.save(rec / "cam0.npy",
            rng.standard_normal((3, 20, 25, 2)).astype(np.float32))
    work = tmp_path / "work"
    (work / "checkpoints").mkdir(parents=True)
    ckpt = save_checkpoint(str(work / "checkpoints" / "epoch_1"), models[2],
                           {"count": torch.tensor(3)}, step=3, epoch=1,
                           steps_per_epoch=3)
    torch.save(models[2].state_dict(), tmp_path / "w.pt")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("model: agcn\nmodel_args: {num_class: 7, "
                   "formulation: pallas}\n")
    answers = []
    for weights in ((flag, ckpt if flag == "--weights" else str(work)),
                    ("--weights", str(tmp_path / "w.pt"))):
        cli_main(["--config", str(cfg), *weights, "--input", str(rec),
                  "--serve", "1", "--interval", "10", "--max-frame", "32",
                  "--device", "cpu"])
        answers.append([ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("[cam")])
    assert len(answers[0]) == 2 and answers[0] == answers[1]


def test_cli_serves_beside_an_empty_recording(models, tmp_path, capsys):
    """A 0-byte .npy (np.load raises EOFError on it) ends its own stream
    with a `!!` line; the good stream beside it answers as it does alone,
    as the root infer.py serves it."""
    torch.save(models[2].state_dict(), tmp_path / "w.pt")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("model: agcn\nmodel_args: {num_class: 7, "
                   "formulation: pallas}\n")
    rng = np.random.default_rng(2)
    cam0 = rng.standard_normal((3, 20, 25, 2)).astype(np.float32)
    answers = {}
    for name, empty in (("alone", False), ("beside", True)):
        rec = tmp_path / name
        rec.mkdir()
        np.save(rec / "cam0.npy", cam0)
        if empty:
            (rec / "cam1.npy").write_bytes(b"")
        cli_main(["--config", str(cfg), "--weights", str(tmp_path / "w.pt"),
                  "--input", str(rec), "--serve", "2", "--interval", "10",
                  "--max-frame", "32", "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        answers[name] = [ln for ln in lines if ln.startswith("[cam")]
        if empty:
            assert any(ln.startswith("!!") and "cam1" in ln for ln in lines)
    assert [ln.split(":")[0] for ln in answers["beside"]] == [
        "[cam0] frame 10", "[cam0] frame 20"]
    assert answers["beside"] == answers["alone"]
