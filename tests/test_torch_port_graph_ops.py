"""The port's plain graph primitives `aggregate` and `embedding_attention`
(agcn_tpu_torch/ops/gcn.py) against agcn_tpu's (ops/gcn.py:24-57) on the
CPU: fp32, within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops import gcn as jgcn
from agcn_tpu_torch.ops import gcn as tgcn
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("adj_shape", [(25, 25), (2, 25, 25),
                                       (2, 4, 25, 25)],
                         ids=["static", "per-sample", "per-frame"])
def test_aggregate_matches_jax(adj_shape):
    """y = x @ A over the joints for a static (V, V), per-sample (B, V, V)
    and per-frame (B, T, V, V) adjacency in A[source, dest] layout; any
    other rank raises ValueError, as in JAX."""
    rng = np.random.default_rng(len(adj_shape))
    x = rng.standard_normal((2, 4, 25, 8)).astype(np.float32)
    a = rng.standard_normal(adj_shape).astype(np.float32)
    got = tgcn.aggregate(torch.from_numpy(x), torch.from_numpy(a))
    want = jgcn.aggregate(jnp.asarray(x), jnp.asarray(a))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    bad = np.zeros((1,) * (5 if len(adj_shape) == 4 else 1), np.float32)
    for agg, lib in ((tgcn.aggregate, torch.from_numpy),
                     (jgcn.aggregate, jnp.asarray)):
        with pytest.raises(ValueError, match="bad adjacency rank"):
            agg(lib(x), lib(bad))


def test_embedding_attention_matches_jax():
    """softmax over the source joint of theta^T phi contracted over (T, Ce)
    and divided by Ce * T: each destination column sums to 1."""
    rng = np.random.default_rng(0)
    th, ph = (rng.standard_normal((2, 6, 25, 8)).astype(np.float32) * 3
              for _ in range(2))
    got = tgcn.embedding_attention(torch.from_numpy(th), torch.from_numpy(ph))
    want = jgcn.embedding_attention(jnp.asarray(th), jnp.asarray(ph))
    assert got.shape == (2, 25, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.sum(dim=-2).numpy(), 1.0, atol=1e-5)
