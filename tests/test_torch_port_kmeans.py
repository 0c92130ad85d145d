"""The port's k-means segment split (agcn_tpu_torch/data/transforms.py
`split_idx_using_kmeans`, numpy only) against agcn_tpu's, which calls
scikit-learn's KMeans(n_init=10, random_state=0): the segment boundaries
equal, the same exception where it raises."""

import warnings

import numpy as np
import pytest

from agcn_tpu.data import transforms as JT
from agcn_tpu_torch.data import transforms as T
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def _walk(rng, n, scale=1.0):
    return (np.cumsum(rng.standard_normal((n, 75)), axis=0)
            * scale).astype(np.float32)


def test_kmeans_split_matches_jax():
    """Seeded random walks of 21-600 frames (more than the 256 samples of
    one of scikit-learn's chunks among them), one with a 30-frame static
    stretch, one with a zero-padded tail, one in float64, and 8 and 30
    segments: boundaries equal to the JAX function's."""
    rng = np.random.default_rng(0)
    seqs = [(_walk(rng, n, s), 20) for n, s in ((21, 1.0), (64, 0.01),
                                                (150, 1.0), (300, 0.1),
                                                (600, 1.0))]
    still = _walk(rng, 120)
    still[40:70] = still[40]
    padded = _walk(rng, 90)
    padded[60:] = 0.0
    seqs += [(still, 20), (padded, 20), (_walk(rng, 80, 3.0), 8),
             (_walk(rng, 200, 0.5), 30),
             (_walk(rng, 70).astype(np.float64), 20)]
    for x, k in seqs:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = JT.split_idx_using_kmeans(x, k)
        got = T.split_idx_using_kmeans(x, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{x.shape} {k}")


def test_kmeans_split_edges_match_jax():
    """20 frames give 19 samples for 20 clusters: ValueError in both; an
    all-equal sequence has one distinct cluster, so the same two bounds in
    both (scikit-learn warns of it); a sequence shorter than two frames
    raises numpy's ValueError in both."""
    for split in (T.split_idx_using_kmeans, JT.split_idx_using_kmeans):
        with pytest.raises(ValueError, match="n_samples=19"):
            split(_walk(np.random.default_rng(1), 20), 20)
        with pytest.raises(ValueError):
            split(np.ones((1, 75), np.float32), 20)
    flat = np.full((40, 75), 0.5, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JT.split_idx_using_kmeans(flat, 20)
    got = T.split_idx_using_kmeans(flat, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 40])
