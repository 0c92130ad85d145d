"""The port's SGN serving on the CPU (`kind="sgn"` in
agcn_tpu_torch/infer/serving.py and realtime.py, `sgn_input` in
preprocess.py, the `--multi-test` CLI): the port's server answers as the
JAX server does for the same frames and weights, batched answers equal
single-stream ones, the recipe's `test_dataloader_args` are taken as
they are, pipelined ticks equal synchronous ones, and `python -m
agcn_tpu_torch.infer --serve` serves a checkpoint that `python -m
agcn_tpu_torch.main` trained.

The model is a small SGN transformer (c_multiplier 0.25) whose JAX
variables move to the port through the port's weight map. Tolerance:
probabilities within 1e-5 (fp32 logits of another summation order, the
crops averaged).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from agcn_tpu.infer.serving import BatchedStreamServer as JaxServer
from agcn_tpu.models import registry as jax_registry
from agcn_tpu_torch.infer import ActionRecognition, BatchedStreamServer
from agcn_tpu_torch.infer.cli import main as cli_main
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.utils.weights import \
    sgn_transformer_state_dict_from_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 6
ARGS = dict(num_class=NUM_CLASS, c_multiplier=0.25,
            spatial_mha_kwargs=dict(num_layers=1, d_model=32, nhead=2,
                                    d_head=8, dim_feedforward=32,
                                    dim_feedforward_output=64, norm="bn",
                                    activation="relu", global_norm=False),
            temporal_mha_kwargs=dict(num_layers=1, nhead=2,
                                     dim_feedforward=64))
RECIPE_ARGS = dict(seg=20, multi_test=5)  # as the shipped recipes set them
KW = dict(kind="sgn", max_seq_length=48, multi_test=5,
          sgn_dataloader_args=RECIPE_ARGS)


def _frames(seed, n_frames=40, v=25):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 1, v, 3)).astype(np.float32) * 0.2
            for _ in range(n_frames)]


@pytest.fixture(scope="module")
def models():
    """The JAX model and variables (BN statistics of a train-mode
    forward), and the port's model with the same weights."""
    jmodel = jax_registry.build_model("sgn_transformer", ARGS)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, 20, 75)).astype(np.float32))

    def init(key, x):
        variables = jmodel.init(key, x, train=False)
        stats = jmodel.apply(variables, x, train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(1)}
                             )[1]["batch_stats"]
        return {"params": variables["params"], "batch_stats": stats}

    variables = jax.tree_util.tree_map(
        np.array, jax.jit(init)(jax.random.PRNGKey(0), x))
    tmodel = registry.build_model("sgn_transformer", ARGS, device="cpu",
                                  num_frame=20)
    tmodel.load_state_dict(sgn_transformer_state_dict_from_variables(
        variables), strict=True)
    return jmodel, variables, tmodel.eval()


def test_port_server_answers_as_jax_server(models):
    """Three streams, five crops each, the same per-stream crops (each
    stream's default_rng(stream id)): the same labels, probabilities
    within 1e-5; two ticks."""
    jmodel, variables, tmodel = models
    jserver = JaxServer(jmodel, variables, max_streams=3, **KW)
    tserver = BatchedStreamServer(tmodel, max_streams=3, **KW)
    frames = {sid: _frames(sid + 10) for sid in range(3)}
    for sid in range(3):
        assert jserver.add_stream() == tserver.add_stream() == sid
    for lo in (0, 20):
        for sid in range(3):
            for f in frames[sid][lo:lo + 20]:
                jserver.append_frame(sid, f)
                tserver.append_frame(sid, f)
        want, got = jserver.predict(), tserver.predict()
        assert set(want) == set(got) == {0, 1, 2}
        for sid in want:
            assert got[sid][0] == want[sid][0]
            np.testing.assert_allclose(got[sid][1], want[sid][1], atol=1e-5)


def test_batched_matches_single_stream(models):
    """Each stream of the batched server (past 4 streams the thread-pool
    slabs fill the rows) answers as a single-stream recognizer drawing
    the same crops (its rng that of the stream id)."""
    tmodel = models[2]
    server = BatchedStreamServer(tmodel, max_streams=6, **KW)
    singles = {}
    for seed in range(6):
        sid = server.add_stream()
        single = ActionRecognition(tmodel, **KW)
        single.rng = np.random.default_rng(sid)
        for f in _frames(seed):
            server.append_frame(sid, f)
            single.append_frame(f)
        singles[sid] = single
    batched = server.predict()
    assert server.last_prep_ms > 0.0
    for sid, single in singles.items():
        label, probs = single.predict()
        assert probs.shape == (NUM_CLASS,)
        assert batched[sid][0] == label
        np.testing.assert_allclose(batched[sid][1], probs, atol=1e-5)


def test_recipe_dataloader_args_and_crops(models):
    """The recipe's test_dataloader_args (which carry multi_test) are
    taken as they are; the explicit multi_test sets the crops: the input
    of a stream is (crops, seg, V*C), and one crop answers apart from
    five."""
    tmodel = models[2]
    rec = ActionRecognition(tmodel, **KW)
    for f in _frames(3):
        rec.append_frame(f)
    x = rec.preproc.sgn_input(multi_crop=True,
                              rng=np.random.default_rng(0))
    assert x.shape == (5, 20, 75)
    assert rec.predict()[1].shape == (NUM_CLASS,)
    one = BatchedStreamServer(tmodel, max_streams=2,
                              **dict(KW, multi_test=1))
    five = BatchedStreamServer(tmodel, max_streams=2, **KW)
    for server in (one, five):
        sid = server.add_stream()
        for f in _frames(3):
            server.append_frame(sid, f)
    assert not np.allclose(one.predict()[0][1], five.predict()[0][1])
    with pytest.raises(ValueError, match="kind"):
        BatchedStreamServer(tmodel, max_streams=2, kind="dense3")


def test_pipelined_matches_sync(models):
    tmodel = models[2]
    sync = BatchedStreamServer(tmodel, max_streams=3, **KW)
    pipe = BatchedStreamServer(tmodel, max_streams=3, **KW)
    for _ in range(3):
        sync.add_stream()
        pipe.add_stream()
    frames = {sid: _frames(sid, n_frames=32) for sid in range(3)}
    want, got = [], []
    for t in range(8, 33, 8):
        for sid in range(3):
            for f in frames[sid][t - 8:t]:
                sync.append_frame(sid, f)
                pipe.append_frame(sid, f)
        want.append(sync.predict())
        r = pipe.predict_async()
        if r is not None:
            got.append(r)
    got.append(pipe.flush())
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        for sid in w:
            assert g[sid][0] == w[sid][0]
            np.testing.assert_allclose(g[sid][1], w[sid][1], atol=1e-5)


def test_cli_serves_a_trained_checkpoint(tmp_path, capsys):
    """`python -m agcn_tpu_torch.main` trains the small SGN transformer
    one epoch on SGN pickles (5-crop eval), `--phase test` reproduces its
    top-1, and `python -m agcn_tpu_torch.infer --serve 2 --device cpu`
    serves the checkpoint with the recipe's crops: every stream answers at
    every tick, and `--multi-test 1` is taken."""
    from agcn_tpu_torch.main import main as train_main

    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("test", 4)):
        data = np.zeros((n, 60, 150), np.float32)
        data[:, :50] = rng.standard_normal((n, 50, 150)) * 0.3
        with open(tmp_path / f"d_{split}.pkl", "wb") as f:
            pickle.dump(data, f)
        with open(tmp_path / f"d_{split}_label.pkl", "wb") as f:
            pickle.dump(np.arange(n) % NUM_CLASS, f)
    feeder = {s: dict(data_path=str(tmp_path / f"d_{s}.pkl"),
                      label_path=str(tmp_path / f"d_{s}_label.pkl"))
              for s in ("train", "test")}
    recipe = dict(
        work_dir=str(tmp_path / "work"), model="sgn_transformer",
        model_args=ARGS, feeder="sgn", use_sgn_dataloader=True,
        train_feeder_args=feeder["train"], test_feeder_args=feeder["test"],
        train_dataloader_args=dict(seg=20, multi_test=1),
        test_dataloader_args=RECIPE_ARGS, optimizer="Adam", base_lr=1e-3,
        batch_size=4, test_batch_size=2, num_epoch=1, label_smoothing=0.1,
        device="cpu", print_log=False)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(recipe))
    train_main(["--config", str(cfg)])
    ckpt = str(tmp_path / "work" / "checkpoints" / "epoch_1.pt")
    train_main(["--config", str(cfg), "--phase", "test", "--weights", ckpt,
                "--work-dir", str(tmp_path / "test")])
    top1 = [json.loads(ln)["top1"] for name in ("work", "test") for ln in
            (tmp_path / name / "metrics.jsonl").read_text().splitlines()
            if json.loads(ln)["kind"] == "eval"]
    assert len(top1) == 2 and top1[0] == top1[1]
    rec = tmp_path / "rec"
    rec.mkdir()
    for i in range(2):
        np.save(rec / f"cam{i}.npy", rng.standard_normal(
            (3, 30, 25, 2)).astype(np.float32))
    capsys.readouterr()
    for extra in ([], ["--multi-test", "1"]):
        cli_main(["--config", str(cfg), "--weights", ckpt, "--input",
                  str(rec), "--serve", "2", "--pipeline", "--timing",
                  "--interval", "10", "--device", "cpu", *extra])
        lines = capsys.readouterr().out.splitlines()
        assert sum(ln.startswith("[cam") for ln in lines) == 2 * 3
        assert sum(ln.startswith("tick:") for ln in lines) == 3
