"""The port's copies of the data modules against agcn_tpu's on the CPU:
the augmentation transforms, `SkeletonDataset` items with every
augmentation on, and `BatchIterator` batches over two shuffled epochs,
from the same seeds. All numpy: the outputs must be equal.
"""

import pickle

import numpy as np
import pytest

from agcn_tpu.data import transforms as jt
from agcn_tpu.data.feeder import SkeletonDataset as JaxDataset
from agcn_tpu.data.pipeline import BatchIterator as JaxIterator
from agcn_tpu_torch.data import transforms as tt
from agcn_tpu_torch.data.feeder import SkeletonDataset
from agcn_tpu_torch.data.pipeline import BatchIterator


def _sample(seed=0, t=40):
    x = np.random.default_rng(seed).standard_normal(
        (3, t, 25, 2)).astype(np.float32)
    x[:, t - 7:] = 0  # trailing padding, as the NTU arrays carry
    return x


@pytest.mark.parametrize("name,args", [
    ("auto_pad", (64,)), ("random_choose", (24,)), ("random_shift", ()),
    ("random_move", ()), ("random_rotation", (0.3,)),
    ("random_flip", (2,)), ("random_axis_scale", (0,)),
    ("random_subsample", (2,)), ("stretch_to_maximum_length", ())])
def test_transforms_match_jax(name, args):
    needs_rng = name not in ("auto_pad", "stretch_to_maximum_length")
    outs = []
    for mod in (jt, tt):
        extra = (np.random.default_rng(5),) if needs_rng else ()
        outs.append(getattr(mod, name)(_sample(), *args, *extra))
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    data = np.stack([_sample(i) for i in range(10)])
    np.save(tmp / "data.npy", data)
    with open(tmp / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(10)], list(range(10))), f)
    return str(tmp / "data.npy"), str(tmp / "label.pkl")


_AUGMENT = dict(random_choose=True, random_shift=True, random_move=True,
                window_size=32, random_zaxis_flip=True,
                random_xaxis_scale=True, random_yaxis_scale=True,
                random_rotation=True, dataset="NTU60-CS")


def test_dataset_items_match_jax(files):
    jds, tds = (cls(*files, **_AUGMENT) for cls in (JaxDataset,
                                                    SkeletonDataset))
    for ds in (jds, tds):
        ds.seed(11)
    for i in range(len(tds)):
        want, got = jds[i], tds[i]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert tds.top_k(np.eye(10), 1) == jds.top_k(np.eye(10), 1) == 1.0


def test_batch_iterator_matches_jax(files):
    jds, tds = (cls(*files, **_AUGMENT) for cls in (JaxDataset,
                                                    SkeletonDataset))
    jit, tit = (JaxIterator(jds, 4, shuffle=True, seed=3),
                BatchIterator(tds, 4, shuffle=True, seed=3, num_workers=2))
    assert len(tit) == len(jit) == 2
    for epoch in range(2):
        jit.set_epoch(epoch)
        tit.set_epoch(epoch)
        for (jx, jy, ji), (tx, ty, ti) in zip(jit, tit, strict=True):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tx, jx)
