"""The port's parallel/edge_partition.py and SyncBN on gloo ranks against
the JAX package (agcn_tpu/parallel/edge_partition.py on the 8 host
devices of tests/conftest.py, agcn_tpu/ops/norm.py on the whole batch).

Four rank processes (tests/torch_port_dist.py, one spawn for the
module) run every function on a (data 2, edge 2) mesh (P = 2, and SyncBN
/ Ghost BN over the two data ranks), then on a (data 1, edge 4) mesh
(P = 4), with T = 7 among the model_edge_gcn cases. Tolerances are the JAX tests' own
(tests/test_edge_partition.py, tests/test_model_edge_partition.py), BN
at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agcn_tpu.graph import build_adjacency
from agcn_tpu.ops.norm import BatchNorm as JaxBatchNorm
from agcn_tpu.parallel import make_mesh
from agcn_tpu.parallel.edge_partition import (edge_partitioned_aggregate,
                                              make_edge_partitioned_gcn,
                                              make_hybrid_partitioned_gcn,
                                              model_edge_gcn)
from tests.torch_port_dist import join, start

B, T, V, C, CO, K = 2, 8, 25, 6, 10, 3


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = dict(
        adj=build_adjacency("ntu_rgb_d"),
        x_agg=rng.standard_normal((4, 6, 25, 16)).astype(f32),
        x_gcn=rng.standard_normal((2, 4, 25, 8)).astype(f32),
        w_gcn=rng.standard_normal((3, 8, 12)).astype(f32),
        w_hybrid=rng.standard_normal((3, 8, 16)).astype(f32),
        x=rng.standard_normal((B, T, V, C)).astype(f32),
        a1=rng.standard_normal((B, K, V, V)).astype(f32),
        w=rng.standard_normal((K, C, CO)).astype(f32),
        probe=rng.standard_normal((B, T, V, CO)).astype(f32),
        bn_x=rng.standard_normal((8, 6, 12)).astype(f32) * 2 + 1,
        bn_g=rng.standard_normal((8, 6, 12)).astype(f32),
        bn_scale=rng.uniform(0.5, 1.5, 12).astype(f32),
        bn_bias=rng.standard_normal(12).astype(f32))
    return inp


# the backend's cheapest optimization: each reference is one jitted
# program, and their compiles are most of this file's time
FAST = {"xla_backend_optimization_level": 0}


def _fast(fn, *args):
    """fn(*args) as one jitted program compiled with FAST, in numpy."""
    compiled = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def _jax_edge(inp, p):
    mesh = make_mesh(data=1, edge=p)
    adj = inp["adj"]
    x_agg, x_gcn = jnp.asarray(inp["x_agg"]), jnp.asarray(inp["x_gcn"])
    want = {}
    for combiner in ("psum", "ppermute"):
        want[f"agg_{combiner}"] = _fast(
            lambda x: edge_partitioned_aggregate(x, adj, mesh,
                                                 combiner=combiner), x_agg)
        fn, parts = make_edge_partitioned_gcn(adj, mesh, combiner=combiner)
        want[f"gcn_{combiner}"] = _fast(fn, x_gcn, parts,
                                        jnp.asarray(inp["w_gcn"]))
    fn, parts = make_hybrid_partitioned_gcn(adj, mesh)
    want["hybrid"] = _fast(fn, x_gcn, parts, jnp.asarray(inp["w_hybrid"]))

    def forward_backward(x, a1, w, probe):
        # y and the gradients of sum(y * probe)
        y, vjp = jax.vjp(lambda *a: model_edge_gcn(*a, mesh=mesh), x, a1, w)
        return y, vjp(probe)

    for tag, frames in (("t8", 8), ("t7", 7)):
        y, grads = _fast(forward_backward,
                         jnp.asarray(inp["x"][:, :frames]),
                         jnp.asarray(inp["a1"]), jnp.asarray(inp["w"]),
                         jnp.asarray(inp["probe"][:, :frames]))
        want[f"model_{tag}"] = y
        for name, g in zip(("dx", "da1", "dw"), grads):
            want[f"{name}_{tag}"] = g
    return want


def _jax_bn(inp, splits, x, g):
    bn = JaxBatchNorm(splits=splits)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = {"scale": jnp.asarray(inp["bn_scale"]),
              "bias": jnp.asarray(inp["bn_bias"])}

    def f(params, x):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = _fast(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True), params, jnp.asarray(x))
    return dict(y=y, dx=dx, dscale=dp["scale"], dbias=dp["bias"],
                mean=stats["mean"], var=stats["var"])


TOLERANCES = {"agg": dict(atol=1e-5), "gcn": dict(atol=1e-4),
              "hybrid": dict(atol=1e-4),
              "model": dict(atol=1e-4, rtol=1e-4),
              "dx": dict(atol=1e-3, rtol=1e-4),
              "da1": dict(atol=1e-3, rtol=1e-4),
              "dw": dict(atol=1e-3, rtol=1e-4)}


LAYOUTS = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the directory of both layouts' rank results, from one spawn of four
    processes; JAX's results for each edge size, computed while the ranks
    run)."""
    tmp = tmp_path_factory.mktemp("edge_ranks")
    np.savez(tmp / "inputs.npz", **_inputs())
    procs = start([{"job": "edge", "world": data * edge, "data": data,
                    "edge": edge, "inputs": str(tmp / "inputs.npz")}
                   for data, edge in LAYOUTS], tmp)
    inp = _inputs()
    want = {edge: _jax_edge(inp, edge) for _, edge in LAYOUTS}
    # BN of the whole batch (SyncBN's reference), and of each half (Ghost
    # BN's, which does not sync)
    want["sync"] = _jax_bn(inp, 1, inp["bn_x"], inp["bn_g"])
    want["ghost"] = [_jax_bn(inp, 2, x, g) for x, g in zip(
        np.split(inp["bn_x"], 2), np.split(inp["bn_g"], 2))]
    join(procs)
    return tmp, want


@pytest.mark.parametrize("data,edge", LAYOUTS)
def test_edge_functions_and_syncbn_on_ranks_match_jax(results, data, edge):
    ranks_dir, want = results
    ranks = [dict(np.load(ranks_dir / f"edge_{data}x{edge}_{r}.npz"))
             for r in range(4)]
    # row-major layout: rank = d * edge + e
    assert [tuple(r["coords"]) for r in ranks] == [
        (r // edge, r % edge) for r in range(4)]
    for key, ref in want[edge].items():
        tol = TOLERANCES[key.split("_")[0]]
        for r, got in enumerate(ranks):
            assert got[key].shape == ref.shape, (key, r)
            np.testing.assert_allclose(got[key], ref, err_msg=f"{key} r{r}",
                                       **tol)
    if data == 1:
        return
    # SyncBN: the two data ranks' halves normalize as the whole batch;
    # the scale and bias gradients sum over them
    halves = [ranks[0], ranks[edge]]  # data coordinates 0 and 1
    ref = want["sync"]
    for name in ("y", "dx"):
        np.testing.assert_allclose(
            np.concatenate([h[f"bn_sync_{name}"] for h in halves]),
            np.asarray(ref[name]), atol=1e-4, err_msg=name)
    for name in ("dscale", "dbias"):
        np.testing.assert_allclose(
            sum(h[f"bn_sync_{name}"] for h in halves),
            np.asarray(ref[name]), atol=1e-4, err_msg=name)
    for h in halves:
        for name in ("mean", "var"):
            np.testing.assert_allclose(h[f"bn_sync_{name}"],
                                       np.asarray(ref[name]), atol=1e-4,
                                       err_msg=name)
    # Ghost BN does not sync (JAX's branch above the psum): each data
    # rank's half alone
    for d, (h, ref) in enumerate(zip(halves, want["ghost"])):
        for name in ("y", "dx", "dscale", "dbias", "mean", "var"):
            np.testing.assert_allclose(h[f"bn_ghost_{name}"],
                                       np.asarray(ref[name]), atol=1e-4,
                                       err_msg=f"ghost {name} d{d}")
