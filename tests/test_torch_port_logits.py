"""The port's attention-logits kernel module
(agcn_tpu_torch/ops/kernels/logits_kernel.py) and the `attention_logits`
forms of agcn_tpu_torch/ops/gcn.py against the JAX package on the CPU.

On the CPU `attention_logits_pallas` runs its plain version (the packed
128 x 128 formulation of the TPU kernel); JAX runs its Pallas kernel in
interpret mode, as tests/test_pallas_gcn.py does. The CUDA kernel itself
is held against the plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerance: atol 1e-5 and rtol 1e-5, the bar of tests/test_pallas_gcn.py's
logits test (fp32 sums of T*Ce = 320 products in another order); the
packing is exact.
bf16 inputs: their products are exact in fp32 and both sides sum in
fp32, so the same bar holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.ops.pallas import logits_kernel as jlk
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops.kernels import logits_kernel as tlk
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# the JAX test's shape (tests/test_pallas_gcn.py:80-93)
B, T, V, K, CE = 3, 20, 25, 3, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _theta_phi(dname, seed=3, shape=(B, T, V, K, CE)):
    """The same seeded theta/phi for both frameworks, in `dname`."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dname]
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    j = [jnp.asarray(a, jd) for a in arrs]
    t = [torch.from_numpy(a).to(td) for a in arrs]
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_packing_matches_jax(dname):
    (jth, jph), (tth, tph) = _theta_phi(dname)
    rows, cols = tlk.pack_rows(tth, K), tlk.pack_cols(tph, K)
    assert rows.shape == (B, tlk.P, T * CE) and cols.shape == (B, T * CE,
                                                               tlk.P)
    np.testing.assert_array_equal(rows.float().numpy(),
                                  _np(jlk.pack_rows(jth, K)))
    np.testing.assert_array_equal(cols.float().numpy(),
                                  _np(jlk.pack_cols(jph, K)))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_packed_logits_plain_matches_jax_kernel(dname):
    (jth, jph), (tth, tph) = _theta_phi(dname)
    want = jlk.packed_logits(jlk.pack_rows(jth, K), jlk.pack_cols(jph, K),
                             interpret=True)
    got = tlk.packed_logits_plain(tlk.pack_rows(tth, K),
                                  tlk.pack_cols(tph, K))
    assert got.dtype == torch.float32 and got.shape == (B, tlk.P, tlk.P)
    # at the JAX test's bar on the logits, the product over the divisor
    np.testing.assert_allclose(got.numpy() / (CE * T),
                               np.asarray(want) / (CE * T), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="expected"):
        tlk.packed_logits_plain(tlk.pack_rows(tth, K)[:, :64],
                                tlk.pack_cols(tph, K))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_entry_point_matches_jax_interpret(dname):
    (jth, jph), (tth, tph) = _theta_phi(dname)
    want = jlk.attention_logits_pallas(jth, jph, CE * T, interpret=True)
    before = tlk.attention_logits_pallas.launches
    got = tlk.attention_logits_pallas(tth, tph, CE * T)
    assert tlk.attention_logits_pallas.launches == before  # plain on CPU
    assert got.dtype == torch.float32 and got.shape == (B, K, V, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_entry_point_takes_the_embedding_views():
    """theta/phi as the strided views of the fused (B, T, V, 2*K*Ce)
    embedding, as a model holds them: the same logits as
    attention_logits(emb, 'transposed') and as JAX's kernel."""
    emb = np.random.default_rng(5).standard_normal(
        (2, 12, 18, 2 * K * 8)).astype(np.float32)
    e = torch.from_numpy(emb).view(2, 12, 18, 2, K, 8)
    th, ph = e[..., 0, :, :], e[..., 1, :, :]
    assert not th.is_contiguous()
    got = tlk.attention_logits_pallas(th, ph, 8 * 12)
    np.testing.assert_allclose(
        got.numpy(), tgcn.attention_logits(torch.from_numpy(emb), K, 8)
        .numpy(), atol=1e-5, rtol=1e-5)
    je = jnp.asarray(emb).reshape(2, 12, 18, 2, K, 8)
    want = jlk.attention_logits_pallas(je[..., 0, :, :], je[..., 1, :, :],
                                       8 * 12, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_launch_checks_before_the_card():
    """The wrapper's checks run before any CUDA call, so they hold on the
    CPU too; the span count depends on the shapes alone."""
    th = torch.zeros(2, 4, 25, 3, 8)
    with pytest.raises(TypeError, match="dtype"):
        tlk.launch_logits(th, th.to(torch.bfloat16), 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tlk.launch_logits(th.double(), th.double(), 1.0)
    with pytest.raises(ValueError, match="joints"):
        big = torch.zeros(1, 2, 33, 3, 4)
        tlk.launch_logits(big, big, 1.0)
    with pytest.raises(ValueError, match="shape"):
        tlk.launch_logits(th, th[:, :2], 1.0)
    # the served batch (16 streams x 2 persons) at T=300, Ce=16 splits
    # the contraction (38 bf16 chunks of 8 frames) into four spans, one
    # wave of the card's block slots; the training batch (128) fills a
    # wave unsplit; a short one is not split
    assert tlk.splits_for(32, 3, 38, torch.bfloat16) == 4
    assert tlk.splits_for(128, 3, 38, torch.bfloat16) == 1
    assert tlk.splits_for(3, 3, 3, torch.bfloat16) == 1


@pytest.mark.parametrize("form", ["transposed", "transposed_tl", "onepack",
                                  "blockdiag", "naive"])
def test_attention_logits_forms_match_jax(form):
    k, ce = 3, 8
    emb = np.random.default_rng(0).standard_normal(
        (2, 12, 25, 2 * k * ce)).astype(np.float32)
    want = jgcn.attention_logits(jnp.asarray(emb), k, ce, form)
    got = tgcn.attention_logits(torch.from_numpy(emb), k, ce, form)
    assert got.shape == (2, k, 25, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
