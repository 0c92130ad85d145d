"""SGN's GCN-stack and head options (gt modes 0, 5 and 6; attn modes 1-3
and 10; gcn_fpn 10 with every `sgcn2_*` option; gcn_fpn_output_merge 2;
the unit and block options `sgcn_ffn` (variants 0xx-3xx),
`sgcn_residual`, `sgcn_prenorm`, `sgcn_g_weighted`, `sgcn_v_kernel`,
`sgcn_kernel` / `sgcn_padding`, `sgcn_g_kernel`; `spatial_maxpool` 0 and
3-5, `temporal_maxpool` 0 and 2-5): the port's eval logits against
agcn_tpu's on the CPU at small widths, fp32, within 2e-4 (ROADMAP's
bar), with the helpers of tests/test_torch_port_sgn_options.py (JAX
variables from `jax.eval_shape` plus seeded values, BN statistics from a
train-mode forward, one JAX program a case). Each model loads the JAX
variables strictly through the port's map, the "Linear" FFNs' keys for
the stacks `linear_ffn_stacks` names. Two tests, for the reason
tests/test_torch_port_sgn_temporal.py gives.
"""

import numpy as np
import pytest
import torch

from agcn_tpu_torch.models import registry
from agcn_tpu_torch.models.sgn import linear_ffn_stacks
from agcn_tpu_torch.utils.weights import sgn_state_dict_from_variables
from tests.test_torch_port_sgn_options import SMALL, _jax_case, _x
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def port_of(args, variables):
    model = registry.build_model("sgn", args, device="cpu", num_frame=20)
    model.load_state_dict(sgn_state_dict_from_variables(
        variables, linear_ffn=linear_ffn_stacks(args)), strict=True)
    return model


@pytest.mark.parametrize("options", [
    [dict(gcn_fpn=10, gcn_fpn_output_merge=2, temporal_maxpool=2,
          multi_t=[[], [], [3, 5]]),
     dict(gcn_fpn=10, sgcn2_dims=[32, 16, 32], sgcn2_attn_mode=10,
          sgcn2_kernel=3, sgcn2_padding=1, sgcn2_v_kernel=3,
          sgcn2_residual=[1, 1, 1], sgcn2_prenorm=True, sgcn2_ffn=304.0,
          sgcn2_dropout=0.2, sgcn_attn_mode=10, sgcn_ffn=4.0),
     dict(spatial_maxpool=0, temporal_maxpool=0, gcn_fpn_output_merge=2,
          sgcn_ffn=204.0, multi_t=[[], [], [3]])],
    [dict(sgcn_gt_mode=0, sgcn_g_proj_dim=[16, 8, 16], sgcn_g_weighted=True,
          sgcn_g_kernel=3, sgcn_kernel=3, sgcn_padding=1, sgcn_v_kernel=3,
          sgcn_residual=[1, 1, 1], sgcn_prenorm=True, sgcn_ffn=104.0,
          sgcn_attn_mode=2, spatial_maxpool=4, temporal_maxpool=3),
     dict(sgcn_gt_mode=5, sgcn_gt_out_channels2=128, sgcn_gt_g3_idx=3,
          sgcn_g_activation="sigmoid", sgcn_attn_mode=1, spatial_maxpool=5,
          temporal_maxpool=4),
     dict(sgcn_gt_mode=6, multi_t=[[3], [3], [3, 5], [3]], sgcn_attn_mode=3,
          spatial_maxpool=3, temporal_maxpool=5)],
], ids=["fpn10-merge2-pools0", "gt0-5-6-attn-unit-pools"])
def test_stack_options_match_jax(options):
    """gcn_fpn 10 with merge 2 (a head a branch) and the max-plus-argmax
    temporal pool; gcn_fpn 10 with every sgcn2 option (attn_mode 10 on
    both stacks, the second reading the injected levels; w2 kernel 3, w0
    kernel 3, residuals across widths, prenorm, the post-norm "Linear"
    FFN, while the first stack's FFN is variant 0); no spatial and no
    temporal pool under merge 2 with the pre-norm "Linear" FFN (a head
    of T V c4 inputs); GT0 with per-unit G blended in (g_weighted), every
    kernel 3, residuals, prenorm, the post-norm FFN, the squeeze-excite
    unit and the 1x1-then-k spatial and k temporal conv pools; GT5 with
    a three-layer head joining the branches, the sigmoid G, two
    projections without G and the k-then-1x1 pools; GT6's maps on a
    branch of their own, w2-only units, the k spatial and k-then-1x1
    temporal pools: eval logits within 2e-4 of JAX's."""
    for opts in options:
        args = dict(SMALL, **opts)
        _, variables, want = _jax_case(args, 13, _x(4), _x(5))
        port = port_of(args, variables).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(_x(5)))
        assert got.shape == (4, 7)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                   err_msg=str(opts))

