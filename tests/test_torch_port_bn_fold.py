"""BN folding (agcn_tpu_torch/utils/bn_fold.py) and the `apply_gcn` forms
(agcn_tpu_torch/ops/gcn.py) against the JAX package on the CPU, at small
sizes (T = 8, batch 2; AAGCN at model_layers 3).

Weights: seeded port models, moved to the JAX layout by the JAX package's
own import maps (`agcn_tpu.utils.torch_import`), folded there by
`agcn_tpu.utils.bn_fold`, and brought back by the port's maps.

Tolerances: the two folds' tensors 1e-6 (the same fp32 arithmetic, in
another order); folded logits against unfolded 2e-4 of the logit scale
(the fold reassociates the BN's multiply into each conv's sums); the GCN
forms' outputs 1e-5 and their gradients 1e-4 of each tensor's scale (fp32
sums of another order over at most 25 x 3 x 64 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.ops import gcn as jgcn
from agcn_tpu.utils import bn_fold as jfold
from agcn_tpu.utils.torch_import import (aagcn_variables_from_torch,
                                         agcn_variables_from_torch)
from agcn_tpu_torch.models.aagcn import AAGCN
from agcn_tpu_torch.models.agcn import AGCN
from agcn_tpu_torch.ops import BatchNorm
from agcn_tpu_torch.ops import gcn as tgcn
from agcn_tpu_torch.ops import norm as tnorm
from agcn_tpu_torch.utils import bn_fold
from agcn_tpu_torch.utils.weights import (aagcn_state_dict_from_variables,
                                          agcn_state_dict_from_variables)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

NUM_CLASS = 7
ADJ = jax_build_adjacency("ntu_rgb_d")
T = 8


def _x(seed=3, n=2, t=T):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 3, t, 25, 2)).astype(np.float32))


def _model(family, fold_bn=False, **kw):
    cls = AGCN if family == "agcn" else AAGCN
    if family == "aagcn":
        kw.setdefault("model_layers", 3)
    return cls(num_class=NUM_CLASS, adj=ADJ, device="cpu", fold_bn=fold_bn,
               generator=torch.Generator().manual_seed(0), **kw)


def _live(model, seed=0):
    """Every BN's affine away from its init (the GCN BN starts at 1e-6),
    AAGCN's attention branch live, then the running statistics set to the
    batch statistics of a train-mode forward (momentum 1): statistics that
    normalize, as AAGCN's eval needs (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, m.weight.shape).astype(np.float32)))
                m.bias.copy_(torch.from_numpy((rng.standard_normal(
                    m.bias.shape) * 0.1).astype(np.float32)))
        for name, p in model.named_parameters():
            if name.endswith("alpha") or "conv_ta" in name or "fc2c" in name:
                p.copy_(torch.from_numpy((rng.uniform(0.1, 0.3, p.shape))
                                         .astype(np.float32)))
    momentum = tnorm.MOMENTUM
    tnorm.MOMENTUM = 1.0
    try:
        with torch.no_grad():
            model.train()(_x(seed=seed + 11))
    finally:
        tnorm.MOMENTUM = momentum
    return model.eval()


_LIVE = {}


def _live_state(family, **kw):
    """The live state dict of a configuration, made once per process."""
    key = (family, tuple(sorted(kw.items())))
    if key not in _LIVE:
        _LIVE[key] = {k: v.clone() for k, v in
                      _live(_model(family, **kw)).state_dict().items()}
    return _LIVE[key]


FAMILIES = [("agcn", {}), ("aagcn", {}), ("aagcn", {"gbn_split": 2})]


@pytest.mark.parametrize("family,kw", FAMILIES)
def test_folded_logits_equal_unfolded(family, kw):
    """Folded weights in a `fold_bn=True` model (the folded BNs skipped)
    and in a plain model (their neutralized affine applied) give the
    unfolded model's eval logits; the input state dict is left as it
    is."""
    sd = _live_state(family, **kw)
    before = {k: v.clone() for k, v in sd.items()}
    fold = (bn_fold.fold_agcn_bn_eval if family == "agcn"
            else bn_fold.fold_aagcn_bn_eval)
    folded = fold(sd)
    assert all(torch.equal(sd[k], before[k]) for k in sd)
    x = _x()
    with torch.no_grad():
        want = _model(family, **kw)
        want.load_state_dict(sd, strict=True)
        want = want.eval()(x)
        for fold_bn in (True, False):
            model = _model(family, fold_bn=fold_bn, **kw)
            model.load_state_dict(folded, strict=True)
            got = model.eval()(x)
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 2e-4 * scale, fold_bn
    # each folded BN is the identity; data_bn stays live
    for name in folded:
        if name.endswith(".running_var") and name.startswith("l"):
            assert torch.all(folded[name] == 1.0 - bn_fold.EPS), name
    assert torch.equal(folded["data_bn.running_var"],
                       sd["data_bn.running_var"])


@pytest.mark.parametrize("family,kw", FAMILIES)
def test_jax_fold_loads_strict_and_equals_the_port_fold(family, kw):
    """The JAX package's fold of the same weights (JAX layout), through
    the port's map, loads strict into a `fold_bn=True` port model and
    equals the port's fold tensor by tensor. AAGCN's state dict holds two
    keys for each unit's conv_d tensor: both carry the one fold."""
    sd = _live_state(family, **kw)
    if family == "agcn":
        variables = agcn_variables_from_torch(sd)
        jax_folded = agcn_state_dict_from_variables(
            jfold.fold_agcn_bn_eval(variables))
        port_folded = bn_fold.fold_agcn_bn_eval(sd)
    else:
        variables = aagcn_variables_from_torch(sd)
        jax_folded = aagcn_state_dict_from_variables(
            jfold.fold_aagcn_bn_eval(variables))
        port_folded = bn_fold.fold_aagcn_bn_eval(sd)
        model = _model(family, **kw)
        assert model.l1.gcn1.conv_d is model.l1.gcn1.agcn.conv_d
        assert "l1.gcn1.agcn.conv_d.0.weight" in sd
        for k in range(3):
            a = port_folded[f"l1.gcn1.conv_d.{k}.weight"]
            assert torch.equal(a, port_folded[f"l1.gcn1.agcn.conv_d.{k}."
                                              "weight"])
            want = sd[f"l1.gcn1.conv_d.{k}.weight"] * (
                sd["l1.gcn1.bn.weight"] / torch.sqrt(
                    sd["l1.gcn1.bn.running_var"] + 1e-5))[:, None, None,
                                                          None]
            torch.testing.assert_close(a, want, atol=1e-6, rtol=1e-6)
    _model(family, fold_bn=True, **kw).load_state_dict(jax_folded,
                                                       strict=True)
    assert set(jax_folded) == set(port_folded)
    for k, v in jax_folded.items():
        if k.endswith("num_batches_tracked"):  # no JAX counterpart
            continue
        np.testing.assert_allclose(port_folded[k].double().numpy(),
                                   v.double().numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_scan_blocks_state_dicts_are_refused():
    """A JAX scan_blocks tree flattened as it is (stacked leaves under
    group names no port model has) is refused, naming the map that
    unstacks it; the state dict of the port's scan_blocks AGCN (the
    unrolled blocks) folds as the unrolled model's does."""
    sd = {"l2_4.gcn1.bn.weight": torch.ones(64)}
    with pytest.raises(ValueError, match="agcn_state_dict_from_variables"):
        bn_fold.fold_agcn_bn_eval(sd)
    scanned = _model("agcn", scan_blocks=True)
    scanned.load_state_dict(_live_state("agcn"), strict=True)
    got = bn_fold.fold_agcn_bn_eval(scanned.state_dict())
    want = bn_fold.fold_agcn_bn_eval(_live_state("agcn"))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the apply_gcn forms ----------------------------------------------------

# (C, Co) of each case; 'hybrid' takes fused_dyn at the small shape
# ((V*C) * (V*Co) = 400 x 400 <= 1600 x 1600) and agg_packed at the large
# one (1600 x 3200)
SMALL, LARGE = (16, 16), (64, 128)
FORMS = [("pf", SMALL), ("custom", SMALL), ("custom", LARGE),
         ("pf_packed", SMALL), ("agg_packed2", SMALL), ("agg_dp", SMALL),
         ("fused_dyn", SMALL), ("hybrid", SMALL), ("hybrid", LARGE)]


@pytest.mark.parametrize("form,shape", FORMS)
def test_gcn_forms_match_jax(form, shape):
    """Each form's output and its three gradients (x, a1, W) against
    `agcn_tpu.ops.gcn.apply_gcn` and `jax.grad`, fp32."""
    c, co = shape
    rng = np.random.default_rng(c + co)
    x = rng.standard_normal((2, 6, 25, c)).astype(np.float32)
    a1 = (rng.standard_normal((2, 3, 25, 25)) * 0.2).astype(np.float32)
    w = (rng.standard_normal((3, c, co)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 6, 25, co)).astype(np.float32)

    def loss(x, a1, w):
        return jnp.sum(jgcn.apply_gcn(x, a1, w, form) * g)

    want = np.asarray(jgcn.apply_gcn(x, a1, w, form))
    grads = jax.grad(loss, (0, 1, 2))(x, a1, w)
    tx, ta, tw = (torch.tensor(v, requires_grad=True) for v in (x, a1, w))
    y = tgcn.apply_gcn(tx, ta, tw, form)
    (y * torch.from_numpy(g)).sum().backward()
    got = y.detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for name, t, j in zip(("dx", "da1", "dW"), (tx, ta, tw), grads):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), (name, err)
    if form == "hybrid":
        inner = "fused_dyn" if shape == SMALL else "agg_packed"
        torch.testing.assert_close(
            y, tgcn.apply_gcn(tx, ta, tw, inner), atol=0.0, rtol=0.0)
