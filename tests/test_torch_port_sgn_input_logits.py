"""SGN's input-side options (`semantic_jdiff`, `xem_projection`,
`semantic_frame_location: 1`, `semantic_joint_smp`, and the body-part
segment embeddings of input modes above 1000): the port's eval logits
against agcn_tpu's on the CPU at small widths, seg 20 (so 5 windows of the
8 part nodes), fp32, within 2e-4 (ROADMAP's bar), with the helpers of
tests/test_torch_port_sgn_options.py (JAX variables from `jax.eval_shape`
plus seeded values, BN statistics from a train-mode forward, one JAX
program a case), each model loaded strictly through the port's map; and
the combinations the JAX model rejects, which raise the same exception
class in the port. Two tests, for the reason
tests/test_torch_port_sgn_temporal.py gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.models import registry as jax_registry
from agcn_tpu_torch.models import registry
from tests.test_torch_port_sgn_options import SMALL, _jax_case, _port, _x
from tests.torch_port_threads import one_torch_thread  # noqa: F401

SEGMENTS = dict(input_position=1001, input_velocity=1002)


@pytest.mark.parametrize("options", [
    [dict(semantic_jdiff=1, semantic_joint_smp=1, gcn_fpn=1),
     dict(semantic_jdiff=2, semantic_joint_fusion=1, xem_projection=2,
          semantic_frame_location=1),
     dict(semantic_jdiff=1, input_velocity=0)],
    [dict(SEGMENTS, semantic_jdiff=1, xem_projection=1, sgcn_gt_mode=5,
          sgcn_gt_out_channels2=128),
     dict(SEGMENTS, sgcn_gt_mode=6, multi_t=[[3], [3], [3, 5], [3]],
          semantic_frame_location=1),
     dict(SEGMENTS, spatial_maxpool=0, semantic_joint_smp=1,
          multi_t=[[], [], [3]])],
], ids=["joint-side", "segments"])
def test_input_options_match_jax(options):
    """The joint-difference embedding fused by concatenation (the GCN's
    input twice c1) and by sum; the joint embedding concatenated before
    the spatial pool of every level of gcn_fpn 1; the projection of modes
    1 and 2 before the stack; the frame embedding added before the stack
    at its input width; jdiff without a velocity stream (JAX's plain
    branch); the segment embeddings (both streams of x, 8 part nodes over
    5 windows) with jdiff, the projection and GT5's head, with GT6's maps
    on a branch of their own and the frame embedding first, and without a
    spatial pool (every part node into the temporal branch) with the
    joint embedding concatenated: eval logits within 2e-4 of JAX's."""
    for opts in options:
        args = dict(SMALL, **opts)
        _, variables, want = _jax_case(args, 19, _x(4), _x(5))
        port = _port(args, variables).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(_x(5)))
        assert got.shape == (4, 7)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                   err_msg=str(opts))


@pytest.mark.parametrize("options, error", [
    (dict(input_position=1001), KeyError),
    (dict(input_position=0, input_velocity=1001), KeyError),
    (dict(input_position=1005, input_velocity=1001), KeyError),
    (dict(SEGMENTS, sgcn_gt_mode=5), ValueError),
], ids=["position-only", "velocity-only", "segment-mode-5", "segments-gt5"])
def test_rejected_combinations_raise_as_in_jax(options, error):
    """One stream above 1000 takes the plain branch, whose embedding has no
    mode 1001; a segment part's MLP has no mode 5; GT5's head of 512
    channels cannot join branches of 128: the JAX model's init raises
    (under `jax.eval_shape`: no program), and so does the port's build,
    with the same exception class."""
    args = dict(SMALL, **options)
    model = jax_registry.build_model("sgn", args)
    with pytest.raises(error):
        jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       jnp.asarray(_x(3)))
    with pytest.raises(error):
        registry.build_model("sgn", args, device="cpu", num_frame=20)
