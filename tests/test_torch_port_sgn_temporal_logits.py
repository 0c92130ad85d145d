"""SGN's temporal-branch and BiFPN options (t_mode 0 and 2-5,
`t_mha_kwargs`, `t_maxpool_kwargs`, `aspp_rates`, gcn_fpn 8): the port's
eval logits against agcn_tpu's on the CPU at small widths, fp32, within
2e-4 (ROADMAP's bar), with the helpers of
tests/test_torch_port_sgn_options.py (JAX variables from
`jax.eval_shape` plus seeded values, BN statistics from a train-mode
forward, one JAX program a case). Two tests, for the reason
tests/test_torch_port_sgn_temporal.py gives.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_sgn_options import _jax_case, _port, _x
from tests.test_torch_port_sgn_temporal import TEMPORAL
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("options", [
    [dict(t_mode=0, multi_t=[[], [], [3]]),
     dict(t_mode=2, aspp_rates=[1, 3, 5],
          t_maxpool_kwargs={"kernel_size": [1, 2]}),
     dict(t_mode=3, t_mha_kwargs={"nhead": [2], "num_layers": 2,
                                  "dim_feedforward": [24],
                                  "pos_enc": "abs", "activation": "gelu"})],
    [dict(t_mode=4, decomp_kernel_size=5),
     dict(t_mode=5, pool_kernel_sizes=[1, 4, 7],
          c_multiplier=[0.25, 0.25, 0.25, 0.0625]),
     dict(gcn_fpn=8, bifpn_dim=24, bifpn_layers=2, multi_t=[[3], [3], [3]],
          t_maxpool_kwargs={"kernel_size": 2, "stride": [1, 3]})],
], ids=["t0-t2-t3-aspp-maxpool", "t4-t5-bifpn"])
def test_temporal_options_match_jax(options):
    """t_mode 0; 2 with its res2 conv (out 128 from 32 channels), behind
    an ASPP of rates 1, 3, 5 and a max pool over time (kernel 2); 3 with
    nhead and dim_feedforward as lists, learned positions, gelu, two
    layers; 4 (decomposition kernel 5); 5 (even and odd pools, kernel 1
    included) whose t_mode-2 MLPs keep the width (no res2); gcn_fpn 8
    with two BiFPN blocks and every level's branch behind a max pool of
    stride 3; at small widths with the BN statistics of a train-mode
    forward: eval logits within 2e-4 of JAX's, each model loading the JAX
    variables strictly through the port's map."""
    for opts in options:
        args = dict(TEMPORAL, **opts)
        _, variables, want = _jax_case(args, 13, _x(4), _x(5))
        port = _port(args, variables).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(_x(5)))
        assert got.shape == (4, 7)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                   err_msg=str(opts))
