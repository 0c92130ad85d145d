"""One train step of the port's AGCN with the fused-GCN kernels' autograd
Functions ('pallas': the forward kernel for y and dx, gcn_bwd for dW and
da1; 'pallas_hybrid': the forward kernel with einsum cotangents) against
agcn_tpu's `make_train_step`, whose Pallas kernels run in interpret mode.
On the CPU the port runs the kernels' plain versions. The set-up and the
atol 2e-4 bar are tests/test_torch_port_train_step.py's.
"""

import pytest

from tests.test_torch_port_train_step import check_one_step, setup  # noqa: F401
from tests.torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("form", ["pallas", "pallas_hybrid"])
def test_one_train_step_matches_jax(setup, form):  # noqa: F811
    check_one_step(*setup, form)
