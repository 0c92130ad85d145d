"""Weights carried across from the JAX package
(the port's copy of the AGCN part of agcn_tpu/utils/torch_export.py and
of the npz/pickle branches of agcn_tpu/train/checkpoint.load_checkpoint).

`agcn_state_dict_from_variables` turns a JAX `{"params", "batch_stats"}`
tree of numpy arrays into the port's state dict (the reference torch
names), which `AGCN.load_state_dict(..., strict=True)` accepts.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def dense_to_pointwise(w) -> np.ndarray:
    """flax dense (in, out) -> torch 1x1 conv (out, in, 1, 1)."""
    return _np(w).T[:, :, None, None]


def conv_to_torch(w) -> np.ndarray:
    """flax conv (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.transpose(_np(w), (3, 2, 0, 1))


def _bn_out(out: Dict[str, np.ndarray], prefix: str,
            params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _np(params["scale"])
    out[f"{prefix}.bias"] = _np(params["bias"])
    out[f"{prefix}.running_mean"] = _np(stats["mean"])
    out[f"{prefix}.running_var"] = _np(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def agcn_state_dict_from_variables(variables: Mapping[str, Any],
                                   num_subset: int = 3
                                   ) -> Dict[str, torch.Tensor]:
    """JAX AGCN variables -> the port's (reference-named) state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    if not stats:
        raise ValueError(
            "the state dict needs batch_stats (BN running statistics); "
            "this checkpoint has none")
    out: Dict[str, np.ndarray] = {}

    _bn_out(out, "data_bn", params["data_bn"], stats["data_bn"])
    out["fc.weight"] = _np(params["fc"]["kernel"]).T
    out["fc.bias"] = _np(params["fc"]["bias"])

    for block in sorted(k for k in params if k.startswith("l")):
        bp, bs = params[block], stats.get(block, {})
        g, gs = bp["gcn1"], bs.get("gcn1", {})
        p = f"{block}.gcn1"
        out[f"{p}.PA"] = _np(g["PA"])
        for k in range(num_subset):
            for role in ("a", "b", "d"):
                out[f"{p}.conv_{role}.{k}.weight"] = dense_to_pointwise(
                    g[f"conv_{role}{k}_kernel"])
                out[f"{p}.conv_{role}.{k}.bias"] = _np(
                    g[f"conv_{role}{k}_bias"])
        _bn_out(out, f"{p}.bn", g["bn"], gs["bn"])
        if "down_conv" in g:
            out[f"{p}.down.0.weight"] = dense_to_pointwise(
                g["down_conv"]["conv"]["kernel"])
            out[f"{p}.down.0.bias"] = _np(g["down_conv"]["conv"]["bias"])
            _bn_out(out, f"{p}.down.1", g["down_bn"], gs["down_bn"])
        out[f"{block}.tcn1.conv.weight"] = conv_to_torch(
            bp["tcn1"]["conv"]["conv"]["kernel"])
        out[f"{block}.tcn1.conv.bias"] = _np(
            bp["tcn1"]["conv"]["conv"]["bias"])
        _bn_out(out, f"{block}.tcn1.bn", bp["tcn1"]["bn"],
                bs["tcn1"]["bn"])
        if "residual" in bp:
            out[f"{block}.residual.conv.weight"] = conv_to_torch(
                bp["residual"]["conv"]["conv"]["kernel"])
            out[f"{block}.residual.conv.bias"] = _np(
                bp["residual"]["conv"]["conv"]["bias"])
            _bn_out(out, f"{block}.residual.bn", bp["residual"]["bn"],
                    bs["residual"]["bn"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint: the JAX package's npz or pickled-dict files
    (a `{"params", "batch_stats", ...}` tree of numpy arrays), or a
    reference `.pt` state dict (a flat name -> tensor dict)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, which needs jax and "
            "orbax to read. Convert it to npz with the JAX package first: "
            "agcn_tpu.train.checkpoint.save_checkpoint(path, "
            "load_checkpoint(dir), use_orbax=False), or export a .pt with "
            "`python -m agcn_tpu.utils.torch_export`.")
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    if path.endswith(".npz") or os.path.exists(path + ".npz"):
        p = path if path.endswith(".npz") else path + ".npz"
        tree: Dict[str, Any] = {}
        with np.load(p, allow_pickle=False) as flat:
            for key in flat.files:
                parts = key.split("/")
                node = tree
                for s in parts[:-1]:
                    node = node.setdefault(s, {})
                node[parts[-1]] = flat[key]
        return tree
    # the JAX package's pickled-dict checkpoints: only files this project
    # wrote — unpickling runs code
    with open(path, "rb") as f:
        return pickle.load(f)


def agcn_state_dict(checkpoint: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """The port's AGCN state dict from what `load_checkpoint` read: a JAX
    variables tree is converted, a reference state dict passes as is."""
    if "params" in checkpoint:
        return agcn_state_dict_from_variables(checkpoint)
    return {k: torch.as_tensor(v) for k, v in checkpoint.items()}
