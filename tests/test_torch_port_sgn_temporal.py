"""The port's temporal-branch and BiFPN options of SGN (`ops/blocks.py`:
ASPP, BiFPN, SeriesDecomposition; t_mode 0 and 2-5, `t_mha_kwargs`,
`t_maxpool_kwargs`, `aspp_rates`, gcn_fpn 8) against agcn_tpu's on the
CPU: here the three blocks alone and the strict loads of the port's
weight map; SGN's eval logits at small widths for each option group in
test_torch_port_sgn_temporal_logits.py, one training step with t_mode 4
and one with gcn_fpn 8 in test_torch_port_sgn_temporal_step.py. Each
file holds at most two tests: xdist's loadfile queue hands out files with
more tests first, so the files of one or two tests run beside the
suite's few-test heavy files at its end instead of delaying their start.

The helpers and bars are tests/test_torch_port_sgn_options.py's: JAX
variables from `jax.eval_shape` plus seeded values (every unit's w1
random), BN statistics from a train-mode forward, one JAX program a case
compiled at the backend's cheapest optimization level.

Tolerances: the blocks 1e-5 (fp32, a few hundred products a sum); fp32
logits 2e-4 (ROADMAP's bar); a step's loss 1e-4 relative and every
gradient 2e-4 of its tensor's scale, BN running statistics 1e-5 of their
scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from agcn_tpu.ops import blocks as jblocks
from agcn_tpu.utils import torch_export
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.ops import blocks
from agcn_tpu_torch.utils.weights import (_aspp_out, _bifpn_out,
                                          sgn_state_dict_from_variables)
from tests.test_torch_port_sgn_options import (SMALL, _fill, _jax_case, _x,
                                               jax_fast)
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def _block_case(module, x, seed):
    """The flax block's variables (seeded, `_fill`), and its outputs in
    eval mode and in train mode (with the running statistics after it)."""
    variables = _fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), x),
                      seed)
    ev = jax_fast(lambda v, x: module.apply(v, x, False), variables, x)
    tr, mut = jax_fast(lambda v, x: module.apply(
        v, x, True, mutable=["batch_stats"]), variables, x)
    return variables, ev, tr, mut["batch_stats"]


def _torch_block(port, variables, out_fn):
    sd = {}
    out_fn(sd, "m", variables["params"], variables["batch_stats"])
    port.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, strict=True)
    return port


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_blocks_match_jax():
    """ASPP (rates 1, 2, 4 over T = 20), BiFPN (three levels of widths 8,
    12, 12 to 16, two blocks) and SeriesDecomposition (kernels 1, 4, 7;
    the moving average of t_mode 5) against agcn_tpu.ops.blocks: outputs
    in eval and in train mode, and the running statistics after the train
    forward, within 1e-5; the names load strictly through the port's
    maps."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 1, 8)).astype(np.float32)
    aspp = jblocks.ASPP(8, dilations=(1, 2, 4), use_bias=True)
    variables, ev, tr, stats = _block_case(aspp, jnp.asarray(x), 4)
    port = _torch_block(blocks.ASPP(8, 8, (1, 2, 4), use_bias=True),
                        variables, _aspp_out)
    xt = torch.from_numpy(x)
    _close(port.eval()(xt), ev)
    _close(port.train()(xt), tr)
    assert port.bn_d2.num_batches_tracked.item() == 1
    for name in ("bn_1x1", "bn_d1", "bn_d2", "bn_d4", "bn_out"):
        for key, buf in (("mean", "running_mean"), ("var", "running_var")):
            _close(getattr(getattr(port, name), buf), stats[name][key])

    feats = [rng.standard_normal((2, 20, 1, c)).astype(np.float32)
             for c in (8, 12, 12)]
    bifpn = jblocks.BiFPN(16, num_layers=2)
    jf = [jnp.asarray(f) for f in feats]
    variables, ev, tr, stats = _block_case(bifpn, jf, 5)
    port = _torch_block(blocks.BiFPN((8, 12, 12), 16, 2), variables,
                        _bifpn_out)
    tf = [torch.from_numpy(f) for f in feats]
    for got, want in zip(port.eval()(tf), ev):
        _close(got, want)
    for got, want in zip(port.train()(tf), tr):
        _close(got, want)
    _close(port.block2.td0_bn.running_var, stats["block2"]["td0_bn"]["var"])

    x = rng.standard_normal((2, 20, 1, 6)).astype(np.float32) * 3.0
    for k in (1, 4, 7):
        want = jblocks.SeriesDecomposition(k).apply({}, jnp.asarray(x))
        got = blocks.SeriesDecomposition(k)(torch.from_numpy(x))
        for g, w in zip(got, want):
            _close(g, w)
        _close(blocks.moving_average(torch.from_numpy(x), k), want[1])


TEMPORAL = dict(SMALL, multi_t=[[3], [3], [3, 5]])


TEMPORAL = dict(SMALL, multi_t=[[3], [3], [3, 5]])


def test_new_names_load_strict(tmp_path):
    """t_mode 2 across widths: the JAX export's keys are in the port's map
    with their values, and the map adds the branch's `res2` only; a JAX
    npz of t_mode 5 with ASPP and of gcn_fpn 8 loads strictly through the
    trainer's checkpoint reader, under the JAX module names."""
    from agcn_tpu.train.checkpoint import save_checkpoint
    from agcn_tpu_torch.train.checkpoint import load_checkpoint

    args = dict(TEMPORAL, t_mode=2, multi_t=[[], [], [3]])
    _, variables, _ = _jax_case(args, 19, None, _x(8))
    got = sgn_state_dict_from_variables(variables)
    want = torch_export.sgn_state_dict_from_variables(variables)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert sorted(set(got) - set(want)) == [
        "tem_mlp_3_1_k3.cnn.res2.conv.bias",
        "tem_mlp_3_1_k3.cnn.res2.conv.weight"]
    for i, opts in enumerate((
            dict(t_mode=5, pool_kernel_sizes=[3], aspp_rates=[1, 2],
                 multi_t=[[], [], [3]]),
            dict(gcn_fpn=8, bifpn_dim=24, multi_t=[[], [3], []]))):
        args = dict(TEMPORAL, **opts)
        _, variables, _ = _jax_case(args, 20 + i, None, _x(8))
        path = str(tmp_path / f"jax{i}")
        save_checkpoint(path, variables, use_orbax=False)
        sd = load_checkpoint(path, "sgn", args)["model"]
        prefix = ("tem_mlp_3_1_k3.aspp.branch_d2.weight" if i == 0
                  else "bifpn.block1.w_td")
        assert prefix in sd
        registry.build_model("sgn", args, device="cpu").load_state_dict(
            sd, strict=True)
