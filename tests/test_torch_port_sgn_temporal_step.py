"""SGN's temporal-branch and BiFPN options: one training step of the
port against agcn_tpu's on the CPU, with t_mode 4 and with gcn_fpn 8, at
small widths (the helpers and bars of tests/test_torch_port_sgn_options.py:
a step's loss 1e-4 relative, every gradient 2e-4 of its tensor's scale,
BN running statistics 1e-5 of their scale). Two tests, for the reason
tests/test_torch_port_sgn_temporal.py gives.
"""

import numpy as np
import pytest

from agcn_tpu_torch.utils.weights import sgn_state_dict_from_variables
from tests.test_torch_port_sgn_options import (_check_grads, _jax_case,
                                               _jax_grads, _port,
                                               _port_grads, _x)
from tests.test_torch_port_sgn_temporal import TEMPORAL
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("options", [
    dict(t_mode=4, gcn_fpn=0, multi_t=[[3], [3], [3]]),
    dict(gcn_fpn=8, bifpn_dim=24, multi_t=[[3], [], [3]]),
], ids=["t_mode4", "gcn_fpn8"])
def test_step_matches_jax(options, monkeypatch):
    """One train-mode step at dropout 0 (label smoothing 0.1) with JAX's
    ReLU masks replayed (the BiFPN's fusion-weight ReLUs among them): the
    loss within 1e-4 relative, every gradient (w_td and w_bu included)
    within 2e-4 of its tensor's scale and the running statistics after
    it. t_mode 4 runs on every level (three branches of three MLPs). With
    one t_mode-4 branch on the last level alone (multi_t [[], [], [3]]),
    jitted JAX's gradients below the spatial max-pool stand 3-30% of
    their scale off eager JAX's, at every XLA level and in float64 as in
    float32, while the port agrees with eager JAX to 1e-6; here jitted
    and eager JAX agree, and the test takes jitted JAX's gradients (eager
    JAX would cost ~40 s)."""
    args = dict(TEMPORAL, **options)
    model, variables, _ = _jax_case(args, 17, _x(6), _x(6))
    x, y = _x(7), np.array([0, 3, 3, 6])
    (want_loss, (inputs, stats, _)), grads = _jax_grads(
        model, variables, x, y, None, monkeypatch)
    port = _port(args, variables).train()
    loss, _, _ = _port_grads(port, x, y, inputs)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _check_grads(port, grads, stats, sgn_state_dict_from_variables)
    if "gcn_fpn" in options and options["gcn_fpn"] == 8:
        assert float(port.bifpn.block1.w_bu.grad.abs().sum()) > 0
