"""The gradient-parity tool of the port (agcn_tpu_torch/tools/grad_parity.py)
on the CPU: the ReLU probe records and replays masks, the bar's floors
apply where the docstring says, the float64 scope keeps `.float()` in
float64, the exact-zero gradient names are zero in a float64 step, and
the max-pool probe replays a reference's selection.
"""

import json

import pytest
import torch

from agcn_tpu_torch.models.registry import build_model
from agcn_tpu_torch.tools import grad_parity as gp
from agcn_tpu_torch.train import losses
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def test_relu_probe_records_and_replays_masks():
    x = torch.tensor([[1.0, -2.0, 1e-7, 3.0]], requires_grad=True)
    record = gp.ReluProbe(keep_inputs=True, keep_margin=True)
    with gp.relu_probe(record):
        torch.relu(x)
    assert torch.relu is gp._RELU
    assert record.masks[0].tolist() == [[True, False, True, True]]
    assert record.margins[0][0, 2] == pytest.approx(1e-7 / 1.5, rel=1e-5)
    # a second run whose tiny input came out negative replays the first
    # run's masks: it passes the input on, and its own sign disagrees
    x2 = torch.tensor([[1.0, -2.0, -1e-7, 3.0 + 3e-3]], requires_grad=True)
    replay = gp.ReluProbe(ref=record)
    with gp.relu_probe(replay):
        y = torch.relu(x2)
    y.sum().backward()
    assert y[0].tolist() == pytest.approx([1.0, 0.0, -1e-7, 3.003])
    assert x2.grad.tolist() == [[1.0, 0.0, 1.0, 1.0]]
    assert replay.disagree == 1
    assert replay.input_diff == pytest.approx(3e-3 / 1.5, rel=1e-4)
    got = gp.flips(replay.masks, record.masks, record.margins)
    assert got["flips"] == 1 and got["at"] == ["l1.gcn1", 0, 2]


def test_grad_errors_bars():
    def t(v):
        return torch.tensor([v], dtype=torch.float64)

    ref = {"fc.weight": t(2.0), "l1.tcn1.bn.bias": t(1e-3),
           "l1.tcn1.conv.bias": t(0.0)}
    grads = {"fc.weight": t(2.0 + 2e-3),
             "l1.tcn1.bn.bias": t(1e-3 + 1.4e-6),
             "l1.tcn1.conv.bias": t(1e-5)}
    rows = {name: ratio for ratio, name, _, _ in
            gp.grad_errors(grads, ref, 1e-3)}
    # 1e-3 of the scale plus 1e-7 of the largest gradient (2.0)
    assert rows["fc.weight"] == pytest.approx(2e-3 / (2e-3 + 2e-7))
    assert rows["l1.tcn1.bn.bias"] == pytest.approx(
        1.4e-6 / (1e-6 + 2e-7))
    # an exact-zero gradient: 1e-5 of the largest
    assert rows["l1.tcn1.conv.bias"] == pytest.approx(0.5)


def test_float_keeps_float64_scope():
    d = torch.ones(2, dtype=torch.float64)
    with gp.float_keeps_float64():
        assert d.float().dtype == torch.float64
        assert torch.ones(2, dtype=torch.bfloat16).float().dtype == \
            torch.float32
    assert d.float().dtype == torch.float32


def test_exact_zero_gradients_are_zero_in_float64():
    model = build_model("agcn", dict(num_class=7, formulation="pallas"),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    gp.condition_bn(model, 1)
    model = model.double()
    x = torch.randn(2, 3, 16, 25, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    with gp.float_keeps_float64():
        _, grads = gp.step_grads(model, losses.cross_entropy, x,
                                 torch.tensor([1, 3]))
    top = max(g.abs().max().item() for g in grads.values())
    zero = {n: g.abs().max().item() for n, g in grads.items()
            if gp.EXACT_ZERO.search(n)}
    # conv_a, conv_d, down, tcn and residual conv biases of ten blocks
    assert len(zero) == 75
    assert max(zero.values()) <= 1e-12 * top
    others = [g.abs().max().item() for n, g in grads.items()
              if n.endswith(".bias") and n not in zero]
    assert min(others) > 1e-9 * top


@pytest.mark.parametrize("model", ["agcn", "aagcn"])
def test_tool_runs_end_to_end(tmp_path, model):
    out = tmp_path / "gp.json"
    assert gp.main(["--model", model, "--batch", "2", "--seq", "8",
                    "--card", "cpu", "--threads", "1", "--out",
                    str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert rows[0]["near_zero"]["inputs"] > 0
    # the "card" is the CPU here: every run equals its CPU counterpart
    same = [r for r in rows[1:] if r["against"] == "cpu fp32"]
    assert len(same) == 8
    assert all(r["worst"] == 0 and r["flips"] == 0 for r in same)


def test_amax_probe_replays_the_reference_selection():
    """A max routes its gradient to the element that attains it; the
    probe records the selection, and a replay routes the gradient (shared
    among ties, as amax's backward shares it) by the reference's, even
    where a near tie now picks another element."""
    x = torch.tensor([[1.0, 3.0, 2.0], [5.0, 5.0, 0.0]])
    ref = gp.AmaxProbe()
    with gp.amax_probe(ref):
        want = torch.amax(x, dim=1)
    assert torch.equal(want, torch.tensor([3.0, 5.0]))
    y = x.clone()
    y[0, 2] = 3.0 + 1e-6  # a near tie the other way
    y.requires_grad_(True)
    probe = gp.AmaxProbe(ref=ref)
    with gp.amax_probe(probe):
        got = torch.amax(y, dim=1, keepdim=True)
    assert torch.amax is gp._AMAX
    got.sum().backward()
    assert (probe.disagree, probe.maxima) == (1, 2)
    assert torch.equal(got[:, 0], torch.tensor([3.0, 5.0]))
    assert torch.equal(y.grad, torch.tensor([[0.0, 1.0, 0.0],
                                             [0.5, 0.5, 0.0]]))
