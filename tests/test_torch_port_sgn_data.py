"""The port's SGN data path and its trainer against agcn_tpu's: the segment
transforms, the batch rotation, the C++ and numpy `flatten_persons`, the
segment collate (train and 5-crop), `SGNDataset`, the pipeline's batches,
the multi-crop eval step, and a two-epoch run of a shrunk
`configs/ntu60_xview/train_sgn.yaml` through `agcn_tpu_torch.main
--device cpu` against the JAX `Trainer`, then `--phase test`.

Tolerances: the data path bit for bit (the same numpy draws in the same
order); the eval step's averaged logits 2e-4 (fp32); the trainer's
per-step losses 1e-3 relative (eight fp32 Adam steps on the same batches,
dropout 0, both started from one checkpoint the JAX package saved, w1 of
every unit random so the G path is live), top-1 equal.
"""

import json
import os
import pickle
import re
import shutil
import warnings

import numpy as np
import pytest
import torch
import yaml

from agcn_tpu import native as jax_native
from agcn_tpu.data import transforms as JT
from agcn_tpu.data.feeder import SGNDataset as JaxSGNDataset
from agcn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from agcn_tpu.data.pipeline import make_sgn_collate as jax_make_sgn_collate
from agcn_tpu.data.sgn_collate import SegmentSampler as JaxSegmentSampler
from agcn_tpu_torch import native
from agcn_tpu_torch.data import transforms as T
from agcn_tpu_torch.data.feeder import SGNDataset
from agcn_tpu_torch.data.pipeline import BatchIterator, make_sgn_collate
from agcn_tpu_torch.data.sgn_collate import SegmentSampler
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "ntu60_xview", "train_sgn.yaml")
N_TRAIN, N_VAL, N_TEST, NUM_CLASS = 16, 4, 10, 4
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native kernels build "
                                      "with g++")


def _sequences(n, seed, t_max=300, separable=False):
    """Seeded (n, t_max, 150) two-person sequences of varying length with
    one-person frames (either slot) and all-zero frames among them."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n, t_max, 150), np.float32)
    labels = np.arange(n) % NUM_CLASS
    for i in range(n):
        t = int(rng.integers(12, t_max + 1))
        seq = rng.standard_normal((t, 150)).astype(np.float32) * 0.3
        seq[rng.random(t) < 0.3, 75:] = 0.0   # person 1 absent
        seq[rng.random(t) < 0.1, :75] = 0.0   # person 0 absent
        seq[rng.random(t) < 0.1] = 0.0        # empty frames
        if separable:
            seq[:, 0::3] += 0.5 * labels[i]
        data[i, :t] = seq
    return data, labels


def _write_split(tmp, name, n, seed):
    data, labels = _sequences(n, seed, separable=True)
    paths = (os.path.join(tmp, f"{name}.pkl"),
             os.path.join(tmp, f"{name}_label.pkl"))
    with open(paths[0], "wb") as f:
        pickle.dump(data, f)
    with open(paths[1], "wb") as f:
        pickle.dump(labels, f)
    return paths


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sgn_data"))
    return {name: _write_split(tmp, name, n, seed) for name, n, seed in
            (("NTU_CV_train", N_TRAIN, 1), ("NTU_CV_val", N_VAL, 2),
             ("NTU_CV_test", N_TEST, 3))}


@pytest.mark.parametrize("length", [20, 21, 37, 64, 150, 300])
def test_segment_splits_match_jax(length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((length, 75)).astype(np.float32)
    for seg in (20, 30):
        np.testing.assert_array_equal(T.split_idx_equal(length, seg),
                                      JT.split_idx_equal(length, seg))
        np.testing.assert_array_equal(T.split_idx_using_auc(x, seg),
                                      JT.split_idx_using_auc(x, seg))
        np.testing.assert_array_equal(T.split_idx_center(length, seg, 0.5),
                                      JT.split_idx_center(length, seg, 0.5))
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        np.testing.assert_array_equal(
            T.split_idx_tempshift(length, seg, 0.2, a),
            JT.split_idx_tempshift(length, seg, 0.2, b))
    for norm in (False, True):
        np.testing.assert_array_equal(T.cumulative_auc(x, norm),
                                      JT.cumulative_auc(x, norm))


def test_batch_rotation_matches_jax():
    x = np.random.default_rng(0).standard_normal((8, 20, 75)).astype(
        np.float32)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    got = T.batch_rotation(x, 0.5, a)
    want = JT.batch_rotation(x, 0.5, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert a.random() == b.random()  # the same draws consumed


@needs_gxx
def test_flatten_persons_cpp_numpy_and_jax_agree():
    """The port's C++ loop, its numpy loop on the nonzero frames, and the
    JAX package's C++ loop give the same frames and subjects."""
    data, _ = _sequences(6, 5)
    sampler = SegmentSampler()
    calls = native.flatten_persons.calls
    for seq in data:
        frames, subj = native.flatten_persons(seq)
        nz = seq.any(axis=-1)
        np_frames, np_subj = sampler.flatten_persons(seq[nz])
        jax_frames, jax_subj = jax_native.flatten_persons(seq)
        for got in (np_frames, jax_frames):
            np.testing.assert_array_equal(frames, got)
        for got in (np_subj, jax_subj):
            np.testing.assert_array_equal(subj, got)
    assert native.flatten_persons.calls == calls + len(data)


@pytest.mark.parametrize("flatten", ["cpp", "numpy"])
@pytest.mark.parametrize("mode", ["train", "test5", "motion", "tempshift"])
def test_collate_matches_jax(monkeypatch, flatten, mode):
    """`SegmentSampler.collate` (train: one crop and the batch rotation;
    test5: five consecutive crops a sample; the motion-AUC and tempshift
    samplers) gives the JAX collate's arrays bit for bit, through the C++
    and through the numpy `flatten_persons`."""
    if flatten == "cpp" and shutil.which("g++") is None:
        pytest.skip("no g++: the native kernels build with g++")
    if flatten == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    data, labels = _sequences(6, 9)
    batch = [(data[i], int(labels[i]), i) for i in range(len(data))]
    kw = {"train": {}, "test5": {}, "motion": {"motion_sampler": 1,
                                               "motion_norm": 1},
          "tempshift": {"tempshift_sampler": 0.2}}[mode]
    train = mode != "test5"
    ours = SegmentSampler(dataset="NTU60-CV-SGN", seg=20, **kw)
    theirs = JaxSegmentSampler(dataset="NTU60-CV-SGN", seg=20, **kw)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    got = ours.collate(batch, a, train=train, multi_crop=not train)
    want = theirs.collate(batch, b, train=train, multi_crop=not train)
    assert got[0].shape == ((6, 20, 75) if train else (30, 20, 75))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_midvel_sampler_matches_jax():
    """`midvel_sampler: 1` (the k-means segment split, here without
    scikit-learn): the train collate (one crop, the batch rotation) and
    the 5-crop test collate give the JAX collate's arrays bit for bit; a
    sequence of no more frames than segments raises ValueError in both
    (scikit-learn's, for fewer samples than clusters)."""
    data, labels = _sequences(6, 9, t_max=120)
    batch = [(data[i], int(labels[i]), i) for i in range(len(data))]
    ours = SegmentSampler(dataset="NTU60-CV-SGN", seg=20, midvel_sampler=1)
    theirs = JaxSegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                               midvel_sampler=1)
    for train in (True, False):
        a, b = np.random.default_rng(12), np.random.default_rng(12)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # sklearn's ConvergenceWarning
            got = ours.collate(batch, a, train=train, multi_crop=not train)
            want = theirs.collate(batch, b, train=train,
                                  multi_crop=not train)
        assert got[0].shape == ((6, 20, 75) if train else (30, 20, 75))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    short = [(data[0][:10], 0, 0)]
    for sampler in (ours, theirs):
        with pytest.raises(ValueError, match="n_samples=19"):
            sampler.collate(short, np.random.default_rng(0), train=True)


def test_sgn_dataset_matches_jax(splits, tmp_path):
    """`SGNDataset`: the train split merged with val (and the warning when
    val is missing), `joint_15`, `debug`, items and `top_k`."""
    (dp, lp), (tp, tl) = splits["NTU_CV_train"], splits["NTU_CV_test"]
    for kw in ({}, {"joint_15": True}, {"merge_val_into_train": False},
               {"debug": True}):
        ours = SGNDataset(dp, lp, **kw)
        theirs = JaxSGNDataset(dp, lp, **kw)
        assert len(ours) == len(theirs)
        np.testing.assert_array_equal(ours.data, theirs.data)
        np.testing.assert_array_equal(ours.label, theirs.label)
        x, y, i = ours[3]
        assert x.dtype == np.float32 and (y, i) == theirs[3][1:]
    assert len(SGNDataset(dp, lp)) == N_TRAIN + N_VAL
    assert SGNDataset(dp, lp, joint_15=True).data.shape[-1] == 90
    lonely = tmp_path / "lonely_train.pkl"
    shutil.copy(dp, lonely)
    with pytest.warns(UserWarning, match="val split"):
        assert len(SGNDataset(str(lonely), lp)) == N_TRAIN
    test = SGNDataset(tp, tl)
    score = np.random.default_rng(0).standard_normal((N_TEST, NUM_CLASS))
    for k in (1, 2):
        assert test.top_k(score, k) == JaxSGNDataset(tp, tl).top_k(score, k)


def test_pipeline_batches_match_jax(splits):
    """`BatchIterator` with `make_sgn_collate`: the epoch's permutation and
    the collate's (seed, epoch, 0) draws give the JAX iterator's batches."""
    dp, lp = splits["NTU_CV_train"]
    for train, multi in ((True, False), (False, True)):
        sampler = dict(dataset="NTU60-CV-SGN", seg=20, multi_test=5)
        ours = BatchIterator(
            SGNDataset(dp, lp), 4, shuffle=train, drop_last=train, seed=5,
            collate=make_sgn_collate(SegmentSampler(**sampler), train,
                                     multi))
        theirs = JaxBatchIterator(
            JaxSGNDataset(dp, lp), 4, shuffle=train, drop_last=train,
            seed=5, collate=jax_make_sgn_collate(
                JaxSegmentSampler(**sampler), train, multi))
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_multi_crop_eval_step_matches_jax():
    """The eval step averages each sample's consecutive crops before the
    loss and the accuracy, as JAX's `make_eval_step(multi_crop=5)`."""
    import jax.numpy as jnp

    from agcn_tpu.train import losses as JL
    from agcn_tpu.train.steps import make_eval_step as jax_eval_step
    from agcn_tpu_torch.train import losses as L
    from agcn_tpu_torch.train.steps import make_eval_step

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20, 7)).astype(np.float32)
    y = rng.integers(0, 7, 4)

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return x

    class State:
        params, batch_stats = {}, {}

        @staticmethod
        def apply_fn(variables, x, train):
            return x

    ours = make_eval_step(Fixed(), L.build_loss("ce", 7, smoothing=0.1),
                          multi_crop=5)
    theirs = jax_eval_step(JL.build_loss("ce", 7, smoothing=0.1),
                           multi_crop=5)
    got, gm = ours(torch.from_numpy(logits), torch.from_numpy(y))
    want, wm = theirs(State, jnp.asarray(logits), jnp.asarray(y))
    assert got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), atol=2e-4)


# -- the trainer: a shrunk train_sgn.yaml through both packages -----------

_STEP = re.compile(r"epoch (\d+) step (\d+)/\d+ loss ([-\d.]+)")


def _recipe(splits, work):
    with open(RECIPE) as f:
        recipe = yaml.safe_load(f)
    (dp, lp), (tp, tl) = splits["NTU_CV_train"], splits["NTU_CV_test"]
    recipe.update(
        work_dir=work, batch_size=4, test_batch_size=4, num_epoch=2,
        eval_interval=1, save_interval=1, log_interval=1, seed=7,
        print_log=False, num_worker=0, device="cpu", mesh_data=1,
        show_topk=[1, 2],
        train_feeder_args=dict(recipe["train_feeder_args"], data_path=dp,
                               label_path=lp),
        test_feeder_args=dict(recipe["test_feeder_args"], data_path=tp,
                              label_path=tl),
        model_args=dict(recipe["model_args"], num_class=NUM_CLASS,
                        c_multiplier=0.25, sgcn_dims=[32, 64, 64],
                        sgcn_g_proj_dim=64, dropout2d=0.0))
    return recipe


def _initial_checkpoint(tmp, model_args):
    """A checkpoint the JAX package wrote: the JAX model's init with every
    unit's w1 random (at init it is zero, and the G path adds nothing)."""
    import jax
    import jax.numpy as jnp

    from agcn_tpu.models.registry import build_model as jax_build
    from agcn_tpu.train.checkpoint import save_checkpoint

    model = jax_build("sgn", model_args)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((2, 20, 75)),
                           train=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.default_rng(4)
    for unit in variables["params"]["sgcn"].values():
        if "w1" in unit:
            k = unit["w1"]["kernel"]
            unit["w1"]["kernel"] = (rng.standard_normal(k.shape)
                                    / np.sqrt(k.shape[0])).astype(np.float32)
    path = os.path.join(tmp, "init")
    save_checkpoint(path, variables, use_orbax=False)
    return path


def _step_losses(work):
    with open(os.path.join(work, "log.txt")) as f:
        return [(int(m[1]), int(m[2]), float(m[3]))
                for m in _STEP.finditer(f.read())]


def _evals(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "eval"]


def _port_run(tmp, recipe, name, *flags):
    from agcn_tpu_torch.main import main

    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    main(["--config", path, *flags])


@pytest.fixture(scope="module")
def runs(splits, tmp_path_factory):
    from agcn_tpu.train.trainer import Trainer as JaxTrainer
    from agcn_tpu.utils.config import Config as JaxConfig

    tmp = str(tmp_path_factory.mktemp("sgn_trainers"))
    jax_recipe = _recipe(splits, os.path.join(tmp, "jax"))
    init = _initial_checkpoint(tmp, jax_recipe["model_args"])
    cfg = JaxConfig()
    for key, value in dict(jax_recipe, weights=init).items():
        setattr(cfg, key, value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JaxTrainer(cfg).start()
    port = _recipe(splits, os.path.join(tmp, "port"))
    _port_run(tmp, port, "port", "--weights", init)
    return tmp, jax_recipe, port


def test_port_trainer_tracks_the_jax_trainer(runs):
    _, jax_recipe, port = runs
    want = _step_losses(jax_recipe["work_dir"])
    got = _step_losses(port["work_dir"])
    assert len(got) == 2 * (N_TRAIN + N_VAL) // 4  # train + val merged
    assert [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-3)
    evals = _evals(port["work_dir"])
    assert [e["top1"] for e in evals] == \
        [e["top1"] for e in _evals(jax_recipe["work_dir"])]
    # one score row a test sample, its crops averaged
    with open(os.path.join(port["work_dir"], "score", "epoch2_val.pkl"),
              "rb") as f:
        assert len(pickle.load(f)) == N_TEST


def test_test_phase_reproduces_the_runs_top1(runs):
    tmp, _, port = runs
    work = os.path.join(tmp, "port_test")
    test = dict(port, work_dir=work, phase="test")
    test.pop("train_feeder_args")
    _port_run(tmp, test, "port_test", "--weights",
              os.path.join(port["work_dir"], "checkpoints", "epoch_2"))
    top1 = _evals(work)[-1]["top1"]
    assert top1 == _evals(port["work_dir"])[-1]["top1"]
    lines = {}
    for name in ("right", "wrong"):
        with open(os.path.join(work, f"{name}.txt")) as f:
            lines[name] = len(f.readlines())
    assert lines["right"] + lines["wrong"] == N_TEST
    assert lines["right"] == round(top1 * N_TEST)
