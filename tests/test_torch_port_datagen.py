"""The port's offline data-generation CLI (`python -m
agcn_tpu_torch.data.gen`, run in-process through `main(argv)`) against
the JAX package's (`agcn_tpu.data.gen.__main__.main`) on a tiny synthetic
raw tree: every `.npy` equal (`np.array_equal`), every label pickle
equal, the printed lines equal. Then the two-stream ensemble end to end:
the port's trainer on the joint and the bone files the port's CLI wrote,
and the root `ensemble.py` over the two score pickles.
"""

import json
import os
import pickle

import numpy as np
import pytest

from agcn_tpu.data.gen.__main__ import main as jax_main
from agcn_tpu_torch.data.gen.__main__ import main as port_main
from tests.test_native import _write_skeleton
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# (camera, subject, action, frames, bodies): xview trains on cameras 2
# and 3, xsub on subjects 1 and 2 of these; actions 1, 8, 9, 27, 31 and 60
# are in openpose's subset, 5 is not
_SAMPLES = [(1, 1, 1, 12, 2), (2, 1, 8, 20, 1), (3, 3, 9, 15, 3),
            (1, 3, 27, 7, 2), (2, 3, 5, 18, 2), (3, 1, 60, 10, 1),
            (2, 2, 31, 16, 2), (1, 2, 8, 9, 2), (3, 2, 1, 14, 2)]
_IGNORED = "S001C003P002R001A001"


def _raw_tree(root):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    for i, (c, p, a, frames, bodies) in enumerate(_SAMPLES):
        _write_skeleton(os.path.join(
            raw, f"S001C{c:03d}P{p:03d}R001A{a:03d}.skeleton"),
            frames=frames, bodies=bodies, seed=i)
    with open(os.path.join(raw, "notes.txt"), "w") as f:
        f.write("not a skeleton\n")
    ignored = os.path.join(root, "ignored.txt")
    with open(ignored, "w") as f:
        f.write(_IGNORED + "\n")
    return raw, ignored


def _kinetics_tree(root):
    """OpenPose JSONs: up to six people a frame (five are read), a frame
    index past 300, a sample without skeleton in the label file."""
    rng = np.random.default_rng(3)
    data = os.path.join(root, "kinetics")
    os.makedirs(data)
    labels = {}
    for i in range(4):
        key = f"clip{i}"
        frames = []
        for t in list(range(6 + 2 * i)) + [301]:
            people = [{"pose": np.round(rng.random(36), 3).tolist(),
                       "score": np.round(rng.random(18) * (rng.random(18)
                                                           > 0.2),
                                         3).tolist()}
                      for _ in range(1 + (t + i) % 6)]
            frames.append({"frame_index": t, "skeleton": people})
        with open(os.path.join(data, f"{key}.json"), "w") as f:
            json.dump({"data": frames, "label": f"action{i % 3}",
                       "label_index": i % 3}, f)
        labels[key] = {"has_skeleton": i != 2, "label_index": i % 3}
    label_path = os.path.join(root, "kinetics_label.json")
    with open(label_path, "w") as f:
        json.dump(labels, f)
    return data, label_path


def _run_both(capsys, argv_of):
    """Run the JAX CLI and the port's with argv_of(side); their printed
    lines."""
    out = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        main(argv_of(side))
        out[side] = capsys.readouterr().out.splitlines()
    return out


def _assert_same_outputs(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _assert_same_outputs(pa, pb)
        elif name.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and np.array_equal(x, y), pa
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert pickle.load(fa) == pickle.load(fb), pa


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    return _raw_tree(str(tmp_path_factory.mktemp("raw")))


@pytest.fixture(scope="module")
def ntu_out(tmp_path_factory, raw_tree):
    """The `ntu` subcommand of both CLIs, xview and xsub, train and eval."""
    raw, ignored = raw_tree
    root = str(tmp_path_factory.mktemp("ntu"))
    for side, main in (("jax", jax_main), ("port", port_main)):
        main(["ntu", "--data-path", raw, "--out-path",
              os.path.join(root, side), "--ignored-sample-path", ignored])
    return root


def test_ntu_equals_jax(ntu_out):
    _assert_same_outputs(os.path.join(ntu_out, "jax"),
                         os.path.join(ntu_out, "port"))
    x = np.load(os.path.join(ntu_out, "port", "xview", "train_data_joint.npy"))
    with open(os.path.join(ntu_out, "port", "xview", "train_label.pkl"),
              "rb") as f:
        names, labels = pickle.load(f)
    want = sorted(f"S001C{c:03d}P{p:03d}R001A{a:03d}.skeleton"
                  for c, p, a, _, _ in _SAMPLES if c in (2, 3))
    want.remove(_IGNORED + ".skeleton")
    assert names == want and x.shape == (len(want), 3, 300, 25, 2)
    assert labels == [int(n[-12:-9]) - 1 for n in names]
    assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_ntu_prints_as_jax(tmp_path, capsys, raw_tree):
    raw, _ = raw_tree
    out = _run_both(capsys, lambda side: [
        "ntu", "--data-path", raw, "--out-path", str(tmp_path / side),
        "--benchmark", "xsub", "--part", "eval"])
    assert out["port"] == out["jax"] == ["ntu xsub eval"]
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("motion", [True, False])
def test_streams_equal_jax(tmp_path, ntu_out, motion):
    joint = os.path.join(ntu_out, "port", "xview", "train_data_joint.npy")
    for side, main in (("jax", jax_main), ("port", port_main)):
        os.makedirs(tmp_path / side)
        main(["streams", "--joint-path", joint, "--out-dir",
              str(tmp_path / side)] + ([] if motion else ["--no-motion"]))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == (["train_data_bone.npy", "train_data_bone_motion.npy",
                      "train_data_joint_motion.npy"] if motion
                     else ["train_data_bone.npy"])
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("skeleton, v", [
    ("ntu_rgb_d", 25), ("kinetics", 18), ("openpose_b25_j15", 15)])
def test_bone_and_motion_streams_equal_jax(skeleton, v):
    """The three skeletons' bone pairs, through the library functions."""
    from agcn_tpu.data.gen.streams import bone_stream as jax_bone
    from agcn_tpu.data.gen.streams import merge_joint_bone as jax_merge
    from agcn_tpu.data.gen.streams import motion_stream as jax_motion
    from agcn_tpu_torch.data.gen import (bone_stream, merge_joint_bone,
                                         motion_stream)

    joint = np.random.default_rng(v).standard_normal(
        (2, 3, 12, v, 2)).astype(np.float32)
    bone = bone_stream(joint, skeleton)
    assert np.array_equal(bone, jax_bone(joint, skeleton))
    assert np.array_equal(motion_stream(bone), jax_motion(bone))
    assert np.array_equal(merge_joint_bone(joint, bone),
                          jax_merge(joint, bone))


@pytest.mark.parametrize("subset", [False, True])
def test_openpose_equals_jax(tmp_path, capsys, raw_tree, subset):
    raw, ignored = raw_tree
    out = _run_both(capsys, lambda side: [
        "openpose", "--data-path", raw, "--out-path", str(tmp_path / side),
        "--ignored-sample-path", ignored, "--benchmark", "xview"]
        + (["--subset"] if subset else []))
    assert out["port"] == out["jax"] == ["openpose xview train",
                                         "openpose xview eval"]
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
    x = np.load(tmp_path / "port" / "xview" / "train_data_joint.npy")
    assert x.shape[1:] == (3, 300, 15, 2)


def test_kinetics_equals_jax(tmp_path, capsys):
    data, label_path = _kinetics_tree(str(tmp_path))
    out = _run_both(capsys, lambda side: [
        "kinetics", "--data-path", data, "--label-path", label_path,
        "--out-dir", str(tmp_path / side)])
    assert out["port"] == out["jax"] == ["kinetics train", "kinetics val"]
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
    x = np.load(tmp_path / "port" / "train_data_joint.npy")
    assert x.shape == (3, 3, 300, 18, 2) and np.abs(x).max() > 0


@pytest.mark.parametrize("args", [
    ["--read-frames"],
    ["--benchmark", "xsub", "--classes", "0", "7", "--read-frames"],
    ["--classes", "4"],
])
def test_explore_raw_prints_as_jax(capsys, raw_tree, args):
    raw, _ = raw_tree
    out = _run_both(capsys, lambda side: ["explore", "--data-path", raw]
                    + args)
    assert out["port"] == out["jax"] and out["port"][0].startswith(
        "samples: ")


@pytest.mark.parametrize("classes", [None, ["7", "26"]])
def test_explore_npy_prints_as_jax(capsys, ntu_out, classes):
    base = os.path.join(ntu_out, "port", "xview")
    out = _run_both(capsys, lambda side: [
        "explore", "--data-path", os.path.join(base, "eval_data_joint.npy"),
        "--label-path", os.path.join(base, "eval_label.pkl")]
        + (["--classes", *classes] if classes else []))
    assert out["port"] == out["jax"] and any(
        ln.startswith("frames: ") for ln in out["port"])


def test_unported_subcommands_name_their_roadmap_items(tmp_path, raw_tree,
                                                      capsys):
    """No subcommand is left unported: `explore --render-sample` draws
    its animation (matplotlib), and without --save it is refused."""
    raw, _ = raw_tree
    port_main(["explore", "--data-path", raw, "--render-sample",
               "S001C001P001R001A001.skeleton", "--save",
               str(tmp_path / "s.gif")])
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"saved {tmp_path / 's.gif'}")
    assert (tmp_path / "s.gif").stat().st_size > 0
    with pytest.raises(SystemExit):  # --render-sample without --save
        port_main(["explore", "--data-path", raw, "--render-sample",
                   "S001C001P001R001A001.skeleton"])


def test_two_stream_ensemble_of_the_ports_trainer(tmp_path, ntu_out,
                                                  capsys):
    """Joint and bone files from the port's CLI, one epoch of the port's
    trainer on each (a one-block AAGCN of width 8, --device cpu), then
    the root ensemble.py over the two `score/epoch1_val.pkl`: its fused
    top-1 equals one computed by hand from the two pickles."""
    import yaml

    import ensemble
    from agcn_tpu_torch.main import main as train_main

    xview = os.path.join(ntu_out, "port", "xview")
    streams = {}
    for part in ("train", "eval"):
        port_main(["streams", "--joint-path",
                   os.path.join(xview, f"{part}_data_joint.npy"),
                   "--out-dir", str(tmp_path), "--no-motion"])
    for stream in ("joint", "bone"):
        feeders = {
            part: {"data_path": (os.path.join(xview, f"{part}_data_joint.npy")
                                 if stream == "joint" else
                                 str(tmp_path / f"{part}_data_bone.npy")),
                   "label_path": os.path.join(xview, f"{part}_label.pkl")}
            for part in ("train", "eval")}
        work = tmp_path / stream
        cfg = {"work_dir": str(work), "model": "aagcn",
               "model_args": {"num_class": 60, "graph": "ntu_rgb_d",
                              "model_layers": 101, "backbone_dim": 8},
               "train_feeder_args": feeders["train"],
               "test_feeder_args": feeders["eval"],
               "batch_size": 2, "test_batch_size": 4, "num_epoch": 1,
               "eval_interval": 1, "save_interval": 1, "base_lr": 0.05,
               "seed": 1, "save_score": True, "print_log": False,
               "num_worker": 0, "device": "cpu"}
        path = tmp_path / f"{stream}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        train_main(["--config", str(path)])
        with open(work / "score" / "epoch1_val.pkl", "rb") as f:
            streams[stream] = pickle.load(f)
        streams[f"{stream}_path"] = str(work / "score" / "epoch1_val.pkl")
    capsys.readouterr()
    label_path = os.path.join(xview, "eval_label.pkl")
    with open(label_path, "rb") as f:
        names, labels = pickle.load(f)
    assert list(streams["joint"]) == list(streams["bone"]) == names
    alpha = 0.7
    accs = ensemble.main(["--label", label_path, "--joint-score",
                          streams["joint_path"], "--bone-score",
                          streams["bone_path"], "--alpha", str(alpha)])
    fused = np.stack([streams["joint"][n] + alpha * streams["bone"][n]
                      for n in names])
    assert fused.shape == (len(names), 60) and np.isfinite(fused).all()
    top1 = float(np.mean(fused.argmax(-1) == np.asarray(labels)))
    assert accs[1] == pytest.approx(top1, abs=0)
    assert capsys.readouterr().out.splitlines()[0] == f"top-1: {top1:.4f}"


def test_openpose_match_equals_jax():
    from agcn_tpu.data.transforms import openpose_match as jax_match
    from agcn_tpu_torch.data.transforms import openpose_match

    x = np.random.default_rng(2).random((3, 16, 18, 3)).astype(np.float32)
    assert np.array_equal(openpose_match(x.copy()), jax_match(x.copy()))


def _square(v):
    return v * v


@pytest.mark.parametrize("processes", [1, 2])
def test_parallel_map_keeps_order(processes):
    from agcn_tpu_torch.utils.parallel_map import parallel_map

    items = list(range(9))
    assert parallel_map(_square, items, processes=processes) == [
        v * v for v in items]
