"""The port's parallel package in one process, against the JAX package:
the COO edge sets and the partitioned adjacency, the host-sharded
BatchIterator, the reassembly of the data ranks' eval scores, the
registry's `edge_mesh` refusals, and the trainer's checks of the world
and the mesh (the multi-rank runs are tests/test_torch_port_parallel_edge
.py and tests/test_torch_port_parallel_train.py)."""

import numpy as np
import pytest
import torch

from agcn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from agcn_tpu.graph import build_adjacency as jax_adjacency
from agcn_tpu.graph import dense_to_edges as jax_dense_to_edges
from agcn_tpu.graph import spatial_edge_sets as jax_spatial_edge_sets
from agcn_tpu.models.registry import build_model as jax_build_model
from agcn_tpu.parallel import make_mesh as jax_make_mesh
from agcn_tpu.parallel.edge_partition import \
    partitioned_adjacency as jax_partitioned_adjacency
from agcn_tpu_torch.data.pipeline import BatchIterator
from agcn_tpu_torch.graph import (EdgeSet, build_adjacency, dense_to_edges,
                                  spatial_edge_sets)
from agcn_tpu_torch.models import build_model
from agcn_tpu_torch.parallel import interleave, make_mesh
from agcn_tpu_torch.parallel import mesh as M
from agcn_tpu_torch.parallel.edge_partition import (model_edge_gcn,
                                                    partitioned_adjacency)
from agcn_tpu_torch.train.steps import seed_dropout
from agcn_tpu_torch.train.trainer import Trainer
from agcn_tpu_torch.utils.config import load_config
from tests.torch_port_threads import one_torch_thread  # noqa: F401

GRAPHS = ("ntu_rgb_d", "kinetics", "openpose_b25_j15")


def _same_edges(ours, theirs):
    assert isinstance(ours, EdgeSet)
    assert ours.num_joints == theirs.num_joints
    assert ours.num_edges == theirs.num_edges
    for name in ("src", "dst", "weight"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.to_dense(), theirs.to_dense())


@pytest.mark.parametrize("graph", GRAPHS)
def test_edge_sets_and_partitioned_adjacency_equal_jax(graph):
    adj = build_adjacency(graph)
    np.testing.assert_array_equal(adj, jax_adjacency(graph))
    for ours, theirs in zip(spatial_edge_sets(graph),
                            jax_spatial_edge_sets(graph), strict=True):
        _same_edges(ours, theirs)
        for parts in (1, 2, 3, 4, 8):
            for a, b in zip(ours.partition(parts), theirs.partition(parts),
                            strict=True):
                _same_edges(a, b)
    for k in range(adj.shape[0]):
        _same_edges(dense_to_edges(adj[k]), jax_dense_to_edges(adj[k]))
    for parts in (1, 2, 3, 4, 8):
        got = partitioned_adjacency(adj, parts)
        np.testing.assert_array_equal(got,
                                      jax_partitioned_adjacency(adj, parts))
        np.testing.assert_allclose(got.sum(axis=0), adj, atol=1e-6)


class _Rows:
    """n samples; sample i is (a row of i, label i % 3, i)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), i % 3, i


@pytest.mark.parametrize("n,shards,batch,shuffle,drop_last", [
    (32, 2, 8, True, True), (30, 4, 3, True, True), (31, 3, 4, False, False),
    (7, 2, 3, False, False), (10, 4, 4, True, False), (5, 1, 2, True, True)])
def test_batch_iterator_shards_equal_jax(n, shards, batch, shuffle,
                                         drop_last):
    for epoch in (0, 3):
        seen = []
        for index in range(shards):
            kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
                      seed=5, num_shards=shards, shard_index=index)
            ours, theirs = BatchIterator(_Rows(n), **kw), JaxBatchIterator(
                _Rows(n), prefetch=0, **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours._indices(), theirs._indices())
            assert len(ours) == len(theirs)
            got = [b[2].tolist() for b in ours]
            assert got == [b[2].tolist() for b in theirs]
            seen += [i for b in got for i in b]
        if not drop_last:  # every sample in some shard
            assert set(seen) == set(range(n))


def _jax_sharded_eval(per_rank, full_rows, crops):
    """JAX trainer's sharded eval (agcn_tpu trainer.py:752-771): each
    batch's replicated logits are the ranks' padded blocks of
    full_rows / crops sample rows, interleaved."""
    nproc = len(per_rank)
    scores = []
    for batches in zip(*per_rank):
        m_rows = batches[0].shape[0]
        per_block = full_rows // crops
        lg = np.concatenate([np.concatenate(
            [b, np.zeros((per_block - m_rows,) + b.shape[1:], b.dtype)])
            for b in batches])
        inter = np.empty((m_rows * nproc,) + lg.shape[1:], lg.dtype)
        for p in range(nproc):
            inter[p::nproc] = lg[p * per_block:p * per_block + m_rows]
        scores.append(inter)
    return np.concatenate(scores)


def _jax_gathered_eval(per_rank):
    """JAX trainer's process-local eval, gathered (:773-784)."""
    gathered = np.stack([np.concatenate(b) for b in per_rank])
    nproc = gathered.shape[0]
    glob = np.empty((nproc * gathered.shape[1],) + gathered.shape[2:],
                    gathered.dtype)
    for p in range(nproc):
        glob[p::nproc] = gathered[p]
    return glob


@pytest.mark.parametrize("n,ranks,batch,crops", [
    (32, 2, 8, 1), (31, 2, 3, 1), (29, 4, 5, 1), (23, 2, 4, 5),
    (17, 4, 3, 5)])
def test_score_reassembly_equals_jax(n, ranks, batch, crops):
    """Each data rank scores its shard (crops rows a sample, averaged);
    the port's interleave of the ranks' rows, cut to n, equals both JAX
    formulas and puts every sample's row in its place."""
    rng = np.random.default_rng(n)
    truth = rng.standard_normal((n, 4)).astype(np.float32)
    per_rank = []
    for index in range(ranks):
        loader = JaxBatchIterator(_Rows(n), batch, drop_last=False,
                                  num_shards=ranks, shard_index=index,
                                  prefetch=0)
        blocks = []
        for _, _, idx in loader:
            # the collate's crop rows, then the eval step's crop mean
            rows = np.repeat(truth[idx], crops, axis=0)
            rows += np.tile(np.linspace(-1, 1, crops, dtype=np.float32),
                            len(idx))[:, None] * (crops > 1)
            blocks.append(rows.reshape(-1, crops, 4).mean(axis=1))
        per_rank.append(blocks)
    ours = interleave([np.concatenate(b) for b in per_rank])[:n]
    np.testing.assert_allclose(ours, truth, atol=1e-6)
    np.testing.assert_array_equal(
        ours, _jax_sharded_eval(per_rank, batch * crops, crops)[:n])
    np.testing.assert_array_equal(ours, _jax_gathered_eval(per_rank)[:n])


@pytest.fixture
def mesh():
    """A 1 x 1 mesh without a process group, unbound after the test."""
    yield make_mesh()
    M.destroy()


def test_registry_edge_mesh_refusals_equal_jax(mesh):
    jax_mesh = jax_make_mesh(data=2, edge=4)
    for name in ("agcn", "aagcn", "model.aagcn.Model",
                 "model.architecture.aagcn.agcn.Model"):
        model = build_model(name, {"num_class": 5}, device="cpu",
                            edge_mesh=mesh)
        unit = model.l1.gcn1
        assert (getattr(unit, "agcn", unit)).edge_mesh is mesh
        assert jax_build_model(name, {"num_class": 5},
                               edge_mesh=jax_mesh).edge_mesh is jax_mesh
    for name in ("aagcn_v17", "aagcn_v32", "aagcn_transformer", "sgn",
                 "sgn_original", "sgn_transformer", "model.sgn_v14.SGN",
                 "agcn_tpu.models.AGCN", "agcn_tpu_torch.models.AGCN"):
        with pytest.raises(ValueError, match="mesh_edge") as ours:
            build_model(name, {"num_class": 5}, device="cpu",
                        edge_mesh=mesh)
        with pytest.raises(ValueError) as theirs:
            jax_build_model(name, {"num_class": 5}, edge_mesh=jax_mesh)
        assert str(ours.value) == str(theirs.value), name


def test_edge_gcn_on_a_one_rank_mesh_is_the_dense_sum(mesh):
    rng = np.random.default_rng(0)
    x, a1, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((2, 5, 25, 6), (2, 3, 25, 25), (3, 6, 10)))
    want = torch.einsum("kbtwc,kco->btwo",
                        torch.einsum("btvc,bkvw->kbtwc", x, a1), w)
    torch.testing.assert_close(model_edge_gcn(x, a1, w, mesh), want)


def _cfg(**kw):
    return load_config(None, dict(dict(device="cpu", model="agcn",
                                       model_args={"num_class": 4}), **kw))


def test_trainer_checks_the_world_and_the_mesh(tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    work = dict(work_dir=str(tmp_path / "work"))
    # no launcher: a recipe asking for more ranks, or a mesh of more
    with pytest.raises(RuntimeError, match="world_size 2 but no launcher"):
        Trainer(_cfg(world_size=2, **work))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        Trainer(_cfg(device=[0, 1], **work))
    with pytest.raises(ValueError, match="mesh_edge 2 .* the world has 1"):
        Trainer(_cfg(mesh_edge=2, **work))
    with pytest.raises(ValueError, match="mesh_data 2 x mesh_edge 1"):
        Trainer(_cfg(mesh_data=2, **work))
    assert M.init_distributed(_cfg(**work)) is None
    assert not M.distributed()
    # a launcher's world against the recipe's, and no silent one-rank run
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError,
                       match="world_size 4 in the recipe but WORLD_SIZE 2"):
        Trainer(_cfg(world_size=4, **work))
    with pytest.raises(RuntimeError, match="WORLD_SIZE 2 but no process"):
        Trainer(_cfg(world_size=2, **work))
    monkeypatch.delenv("WORLD_SIZE")
    # ddp: true is read nowhere, as in JAX; one process, no mesh
    trainer = Trainer(_cfg(ddp=True, **work))
    assert trainer.mesh is None and trainer.data == 1
    assert not M.distributed()


def test_data_ranks_fold_into_the_dropout_seed():
    """Data rank 0 draws the one-process masks; another data rank its
    own; the edge ranks of a data rank share its `dropout_shard`."""

    class Model(torch.nn.Module):
        dropout_seed = 7

        def __init__(self, shard=None):
            super().__init__()
            self.dropout_generator = torch.Generator()
            if shard is not None:
                self.dropout_shard = shard

    draws = {}
    for shard in (None, 0, 1, 1):
        model = Model(shard)
        seed_dropout(model, 3)
        draws.setdefault(shard, []).append(
            torch.rand(4, generator=model.dropout_generator))
    torch.testing.assert_close(draws[None][0], draws[0][0])
    torch.testing.assert_close(draws[1][0], draws[1][1])
    assert not torch.equal(draws[0][0], draws[1][0])
