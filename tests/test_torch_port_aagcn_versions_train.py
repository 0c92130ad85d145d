"""Training the port's AAGCN v31 (agcn_tpu_torch/models/aagcn_versions.py)
against the JAX package on the CPU: one train-mode step's loss and
gradients, and `agcn_tpu_torch.main --device cpu` on a
train_joint_aagcn_v31.yaml-shaped recipe against the JAX `Trainer`.

The recipe's model (model_layers 101, kernel 3, no pad, backbone 16, t/s
model 16, FF 64, 'sa-t' with add_A, cos-sin positions) cut to one of its
three interleaved layers (the JAX programs' compiles take most of this
file's time), with 4 classes and dropout 0 (the two frameworks' masks
cannot match), on T = 16 frames: the JAX trainer initializes every dense model
at T = 16 (agcn_tpu/train/trainer.py:213-224), so its v31 runs only at
that T, where the port sizes the spatial tokens from its data's T (T' =
5 here).

Tolerances: the step's loss and every gradient 2e-4 (the model bar of
tests/test_aagcn.py, as tests/test_torch_port_transformer.py holds the
transformer's step; the BN affines conditioned to keep ReLU inputs off
the kink); the trainers' loss at every step 1e-4
relative, top-1 equal.
"""

import json
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agcn_tpu.graph import build_adjacency as jax_build_adjacency
from agcn_tpu.models.aagcn_versions import AAGCNv31 as JaxV31
from agcn_tpu.train import losses as jlosses
from agcn_tpu.train.checkpoint import save_checkpoint
from agcn_tpu.train.trainer import Trainer as JaxTrainer
from agcn_tpu.utils.config import Config as JaxConfig
from agcn_tpu_torch.main import main as port_main
from agcn_tpu_torch.models import registry
from agcn_tpu_torch.train import losses as tlosses
from agcn_tpu_torch.utils import weights
from tests.test_torch_port_aagcn_versions import fill, jax_fast
from tests.torch_port_threads import one_torch_thread  # noqa: F401

ADJ = jax_build_adjacency("ntu_rgb_d")
_STEP = re.compile(r"epoch (\d+) step (\d+)/\d+ loss ([-\d.]+)")
N, T, CLASSES = 16, 16, 4
# train_joint_aagcn_v31.yaml's model_args: 4 classes, dropout 0, one layer
RECIPE = dict(num_class=CLASSES, num_point=25, num_person=2,
              graph="ntu_rgb_d", model_layers=101, kernel_size=3,
              pad=False, backbone_dim=16, t_model_dim=16, t_ffn_dim=64,
              s_model_dim=16, s_ffn_dim=64, num_layers=1, trans_seq="sa-t",
              add_A=True, pos_enc="cossin", dropout=0.0)


def _conditioned(variables, seed=0):
    """BN shifts 0.5-0.7 over scales 0.1-0.2 (the backbone's BNs), which
    keep ReLU inputs away from the kink for gradient parity
    (tests/test_torch_port_train_step.py)."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif name in ("bn", "down_bn", "data_bn") and k == "scale":
                out[k] = rng.uniform(0.1, 0.2, v.shape).astype(np.float32)
            elif name in ("bn", "down_bn", "data_bn") and k == "bias":
                out[k] = rng.uniform(0.5, 0.7, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"params": walk(variables["params"], ""),
            "batch_stats": variables["batch_stats"]}


def _variables(seed=0):
    model = JaxV31(adj=ADJ, **{k: v for k, v in RECIPE.items()
                               if k != "graph"})
    x = jnp.zeros((2, 3, T, 25, 2), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    return model, _conditioned(fill(shapes, seed), seed)


def test_one_train_step_matches_jax():
    """Train mode (BN batch statistics), dropout 0, the recipe's 'sa-t'
    v31: the loss and every parameter's gradient; none is left without
    one."""
    jmodel, variables = _variables()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, T, 25, 2)).astype(np.float32)
    y = np.array([1, 3])

    def loss_of(params):
        (logits, _), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy(logits, jnp.asarray(y))

    jloss, jgrads = jax_fast(jax.value_and_grad(loss_of),
                             variables["params"])
    want = weights.aagcn_v31_state_dict_from_variables(
        {"params": jgrads,
         "batch_stats": variables["batch_stats"]})
    model = registry.build_model("aagcn_v31", RECIPE, device="cpu",
                                 num_frame=T)
    model.load_state_dict(weights.model_state_dict(variables, "aagcn_v31"),
                          strict=True)
    loss = tlosses.cross_entropy(model.train()(torch.from_numpy(x)),
                                 torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=2e-4)
    names = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)
        names += 1
    assert names > 90


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, 3, T, 25, 2)).astype(np.float32) * 0.5
    labels = (np.arange(N) % CLASSES).tolist()
    for i, label in enumerate(labels):
        data[i, 0] += 0.5 * label
    np.save(tmp / "data.npy", data)
    with open(tmp / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(N)], labels), f)
    feeder = {"data_path": str(tmp / "data.npy"),
              "label_path": str(tmp / "label.pkl"), "window_size": T}
    init = str(tmp / "init")
    save_checkpoint(init, _variables(seed=3)[1], use_orbax=False)
    return feeder, init


def _recipe(tmp_path, work, feeder):
    """train_joint_aagcn_v31.yaml's training settings (SGD nesterov, lr
    0.1, warm-up 5, decay 1e-4), shrunk to 2 epochs of 4 batches."""
    return {"work_dir": str(tmp_path / work), "model": "aagcn_v31",
            "model_args": RECIPE, "train_feeder_args": feeder,
            "test_feeder_args": feeder, "optimizer": "SGD",
            "nesterov": True, "base_lr": 0.1, "step": [30, 40],
            "weight_decay": 0.0001, "warm_up_epoch": 5, "batch_size": 4,
            "test_batch_size": 8, "num_epoch": 2, "eval_interval": 1,
            "save_interval": 2, "log_interval": 1, "seed": 7,
            "print_log": False, "mesh_data": 1, "num_worker": 0,
            "device": "cpu"}


def _steps(path):
    with open(path / "log.txt") as f:
        return [(int(m[1]), int(m[2]), float(m[3]))
                for m in _STEP.finditer(f.read())]


def _evals(path):
    with open(path / "metrics.jsonl") as f:
        return [r["top1"] for r in map(json.loads, f) if r["kind"] == "eval"]


def test_port_trainer_tracks_the_jax_trainer(tmp_path, files):
    """`agcn_tpu_torch.main --device cpu` on the v31 recipe against the
    JAX Trainer, both from one npz the JAX package saved: every step's
    loss over two epochs and each epoch's top-1."""
    feeder, init = files
    cfg = JaxConfig()
    for key, value in dict(_recipe(tmp_path, "jax", feeder),
                           weights=init).items():
        setattr(cfg, key, value)
    JaxTrainer(cfg).start()
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(_recipe(tmp_path, "port", feeder)))
    port_main(["--config", str(path), "--weights", init])
    want, got = _steps(tmp_path / "jax"), _steps(tmp_path / "port")
    assert len(got) == 8 and [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want],
                               rtol=1e-4)
    assert _evals(tmp_path / "port") == _evals(tmp_path / "jax")
