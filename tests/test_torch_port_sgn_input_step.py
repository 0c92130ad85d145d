"""SGN's input-side options: one training step of the port against
agcn_tpu's on the CPU at small widths, seg 20, with the segment
embeddings under jdiff and the projection, and with the joint embedding
before the spatial pools of gcn_fpn 1 and the frame embedding before the
stack (the helpers and bars of tests/test_torch_port_sgn_options.py: a
step's loss 1e-4 relative, every gradient 2e-4 of its tensor's scale, BN
running statistics 1e-5 of their scale, JAX's ReLU masks replayed). Two
tests, for the reason tests/test_torch_port_sgn_temporal.py gives.
"""

import numpy as np
import pytest

from agcn_tpu_torch.utils.weights import sgn_state_dict_from_variables
from tests.test_torch_port_sgn_options import (SMALL, _check_grads,
                                               _jax_case, _jax_grads, _port,
                                               _port_grads, _x)
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("options", [
    dict(input_position=1001, input_velocity=1002, semantic_jdiff=1,
         xem_projection=1, multi_t=[[], [], [3]]),
    dict(semantic_joint_smp=1, gcn_fpn=1, semantic_frame_location=1,
         semantic_jdiff=1, semantic_joint_fusion=1, multi_t=[[3], [3], [3]]),
], ids=["segments-jdiff-xem", "smp-fpn1-frame-first"])
def test_step_matches_jax(options, monkeypatch):
    """One train-mode step at dropout 0 (label smoothing 0.1) with JAX's
    ReLU masks replayed: the eight part MLPs of both streams (each with its
    DataNorm's batch statistics), the joint and joint-difference tables
    concatenated, the projection; and the joint table concatenated on
    every level before its max-pool, the frame table added before the
    stack, jdiff summed: the loss within 1e-4 relative, every gradient
    within 2e-4 of its tensor's scale and the running statistics after
    it."""
    args = dict(SMALL, **options)
    model, variables, _ = _jax_case(args, 23, _x(6), _x(6))
    x, y = _x(7), np.array([0, 3, 3, 6])
    (want_loss, (inputs, stats, _)), grads = _jax_grads(
        model, variables, x, y, None, monkeypatch)
    port = _port(args, variables).train()
    loss, _, _ = _port_grads(port, x, y, inputs)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _check_grads(port, grads, stats, sgn_state_dict_from_variables)
