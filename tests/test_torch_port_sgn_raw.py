"""The port's SGN raw data generation (`agcn_tpu_torch/data/gen/sgn_raw.py`,
`sgn.py` and `python -m agcn_tpu_torch.data.gen sgn-raw`) against the JAX
package's on the CPU, on a seeded synthetic raw tree
(`agcn_tpu_torch/tools/sgn_raw_tree.py`: one to four bodies with their
own IDs, empty frames, short, wide, returning, sequential and tied
bodies): the parse, the denoising (order and motions) and the actor
assembly array for array; the sklearn-free train/val split against
sklearn's `train_test_split`; the 12 pickles of both CLIs byte for byte;
`dense_to_sgn` / `gendata_from_dense` as tests/test_data_gen.py holds
them. Everything is exact: no tolerance.
"""

import os
import pickle

import numpy as np
import pytest

from agcn_tpu.data.gen import sgn as jsgn
from agcn_tpu.data.gen import sgn_raw as jraw
from agcn_tpu.data.gen.__main__ import main as jax_main
from agcn_tpu_torch.data.gen import sgn as tsgn
from agcn_tpu_torch.data.gen import sgn_raw as traw
from agcn_tpu_torch.data.gen.__main__ import main as port_main
from agcn_tpu_torch.tools.sgn_raw_tree import SCENARIOS, write_sgn_raw_tree

SAMPLES = 2 * len(SCENARIOS) + 1  # every scenario twice, one missing


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sgn_raw"))
    return root, write_sgn_raw_tree(root, SAMPLES, seed=5)


def _same_body(a, b):
    for field in ("joints", "colors", "interval"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert a.motion == b.motion


def _appearances(text):
    """Each body ID's valid-frame indices, read from the text."""
    lines = text.splitlines()
    pos, valid, seen = 1, -1, {}
    for _ in range(int(lines[0])):
        n = int(lines[pos])
        pos += 1
        valid += n > 0
        for _ in range(n):
            seen.setdefault(lines[pos].split()[0], []).append(valid)
            pos += 2 + int(lines[pos + 1])
    return list(seen.values())


def test_chain_equals_jax(tree):
    """Per file: the parsed bodies (IDs in first-appearance order, joints,
    colors, the chained intervals, motions), the denoised list (its order
    and the motions it lowered in place) and the assembled actors bit for
    bit; then the translation and alignment of all of them. The tree takes
    each denoising branch: a body dropped for length and one for spread,
    a motion lowered by the spread filter, a sample whose bodies are all
    short, a returning body, a motion tie."""
    _, (_, raw_dir, names) = tree
    seqs = {"jax": [], "port": []}
    seen = set()
    for name in names:
        path = os.path.join(raw_dir, name + ".skeleton")
        with open(path) as f:
            text = f.read()
        j, t = jraw.parse_skeleton_text(text, name), \
            traw.parse_skeleton_text(text, name)
        assert (t.name, t.num_frames) == (j.name, j.num_frames)
        assert list(t.bodies) == list(j.bodies)
        for bid in j.bodies:
            _same_body(t.bodies[bid], j.bodies[bid])
        before = {bid: b.motion for bid, b in j.bodies.items()}
        jd, td = jraw.denoise_bodies(j), traw.denoise_bodies(t)
        assert [b for b, _ in td] == [b for b, _ in jd]
        for (_, a), (_, b) in zip(td, jd):
            _same_body(a, b)
        for bid in j.bodies:  # the in-place motion updates
            _same_body(t.bodies[bid], j.bodies[bid])
        if len(j.bodies) > 1:
            kept = [b for b, _ in jd]
            short = {bid: len(b.interval) <= jraw.MAX_BODY_LEN_THRES
                     for bid, b in j.bodies.items()}
            if all(short.values()):
                seen.add("all_short")
            else:
                seen.update("short" if short[bid] else "wide"
                            for bid in j.bodies if bid not in kept)
            if any(j.bodies[bid].motion < m for bid, m in before.items()):
                seen.add("motion_lowered")
            motions = [b.motion for _, b in jd]
            if len(set(motions)) < len(motions):
                seen.add("tie")
        if any(np.any(np.diff(f) > 1) for f in _appearances(text)):
            seen.add("returns")  # chained into one block all the same
        for key, mod in (("jax", jraw), ("port", traw)):
            seqs[key].append(mod.assemble_actors(mod.parse_skeleton_file(
                path)))
        a, b = seqs["port"][-1], seqs["jax"][-1]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert seen == {"short", "wide", "all_short", "motion_lowered", "tie",
                    "returns"}, seen
    assert {s.shape[1] for s in seqs["jax"]} == {75, 150}
    for a, b in zip(traw.seq_translation(seqs["port"]),
                    jraw.seq_translation(seqs["jax"])):
        assert np.array_equal(a, b)
    assert np.array_equal(traw.align_frames(seqs["port"]),
                          jraw.align_frames(seqs["jax"]))


@pytest.mark.parametrize("n", [2, 7, 20, 37, 1000])
def test_split_train_val_equals_sklearn(n):
    """train_test_split(test_size=0.05, random_state=10000) of an index
    array, and at another ratio and seed: the same arrays, in the same
    order, of the same dtype; a train set left empty raises in both."""
    from sklearn.model_selection import train_test_split

    idx = np.arange(n) * 3 + 11
    for ratio, seed in ((0.05, 10000), (0.3, 7)):
        want = train_test_split(idx, test_size=ratio, random_state=seed)
        got = traw.split_train_val(idx, ratio, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError):
        train_test_split(idx[:1], test_size=0.05, random_state=10000)
    with pytest.raises(ValueError, match="train set will be empty"):
        traw.split_train_val(idx[:1])


def test_sgn_raw_cli_writes_jax_bytes(tree):
    """`sgn-raw --evaluations CS CV` through both CLIs: the same 12 files
    byte for byte; (n, 300, 150) float32 arrays, 0-based int labels, the
    missing sample left out, every kept sample in exactly one of each
    evaluation's train / val / test."""
    root, (stat_dir, raw_dir, names) = tree
    outs = {}
    for key, main in (("jax", jax_main), ("port", port_main)):
        outs[key] = os.path.join(root, f"out_{key}")
        main(["sgn-raw", "--stat-dir", stat_dir, "--skeleton-root", raw_dir,
              "--out-dir", outs[key], "--evaluations", "CS", "CV"])
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"]))
    assert len(files) == 12
    for fname in files:
        with open(os.path.join(outs["jax"], fname), "rb") as f:
            want = f.read()
        with open(os.path.join(outs["port"], fname), "rb") as f:
            assert f.read() == want, fname
    for ev in ("CS", "CV"):
        total = 0
        for split in ("train", "val", "test"):
            base = os.path.join(outs["port"], f"NTU_{ev}_{split}")
            with open(base + ".pkl", "rb") as f:
                data = pickle.load(f)
            with open(base + "_label.pkl", "rb") as f:
                labels = pickle.load(f)
            assert data.dtype == np.float32 and data.shape[1:] == (300, 150)
            assert len(labels) == len(data) > 0
            assert labels.min() >= 0 and labels.max() <= 4
            total += len(data)
        assert total == len(names)


def test_dense_to_sgn_equals_jax(tmp_path):
    """dense_to_sgn on (N, 3, T, 25, 2) data with empty frames, an absent
    second body and an empty sample, and gendata_from_dense's two pickles
    (labels from a (names, labels) pickle), bit for bit as JAX's."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((4, 3, 40, 25, 2)).astype(np.float32)
    data[0, :, 30:] = 0.0
    data[1, :, :, :, 1] = 0.0
    data[2, :, :5] = 0.0
    data[3] = 0.0
    want = jsgn.dense_to_sgn(data)
    got = tsgn.dense_to_sgn(data)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.save(tmp_path / "joint.npy", data)
    with open(tmp_path / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(4)], [3, 0, 2, 1]), f)
    for key, mod in (("jax", jsgn), ("port", tsgn)):
        mod.gendata_from_dense(str(tmp_path / "joint.npy"),
                               str(tmp_path / "label.pkl"),
                               str(tmp_path / key), "train", "CS")
    for fname in ("NTU_CS_train.pkl", "NTU_CS_train_label.pkl"):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes()
