"""SGN's GCN-stack and head options: one training step of the port
against agcn_tpu's on the CPU at small widths, with gcn_fpn 10 under
gcn_fpn_output_merge 2 and with the prenorm / FFN / residual unit
options (the helpers and bars of tests/test_torch_port_sgn_options.py: a
step's loss 1e-4 relative, every gradient 2e-4 of its tensor's scale, BN
running statistics 1e-5 of their scale). Jitted and eager JAX agree on
both configurations (eager JAX, op by op, costs 8-22 s a step here), so
the test takes jitted JAX's gradients. Two tests, for the reason
tests/test_torch_port_sgn_temporal.py gives.
"""

import numpy as np
import pytest

from agcn_tpu_torch.utils.weights import sgn_state_dict_from_variables
from tests.test_torch_port_sgn_options import (SMALL, _check_grads,
                                               _jax_case, _jax_grads, _port,
                                               _port_grads, _x)
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("options", [
    dict(gcn_fpn=10, gcn_fpn_output_merge=2, sgcn2_attn_mode=10,
         sgcn2_residual=[1, 0, 1], sgcn2_dims=[32, 16, 32],
         temporal_maxpool=2, multi_t=[[], [], [3, 5]]),
    dict(sgcn_prenorm=True, sgcn_ffn=104.0, sgcn_residual=[1, 1, 1],
         sgcn_v_kernel=3, sgcn_kernel=3, sgcn_padding=1, sgcn_gt_mode=0,
         spatial_maxpool=4, gcn_fpn=0, multi_t=[[3], [3], [3]]),
], ids=["fpn10-merge2", "prenorm-ffn"])
def test_step_matches_jax(options, monkeypatch):
    """One train-mode step at dropout 0 (label smoothing 0.1) with JAX's
    ReLU masks replayed: the second stack reading the first's last G and
    the injected levels (attn_mode 10, a residual across widths), two
    heads averaged, the argmax temporal pool's projection; and prenorm
    BNs before every unit and temporal MLP layer, post-norm FFNs,
    residuals, w0 and w2 of kernel 3, GT0's G, the 1x1-then-k spatial
    pool on every level: the loss within 1e-4 relative, every gradient
    within 2e-4 of its tensor's scale and the running statistics after
    it."""
    args = dict(SMALL, **options)
    model, variables, _ = _jax_case(args, 17, _x(6), _x(6))
    x, y = _x(7), np.array([0, 3, 3, 6])
    (want_loss, (inputs, stats, _)), grads = _jax_grads(
        model, variables, x, y, None, monkeypatch)
    port = _port(args, variables).train()
    loss, _, _ = _port_grads(port, x, y, inputs)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _check_grads(port, grads, stats, sgn_state_dict_from_variables)
