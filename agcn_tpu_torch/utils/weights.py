"""Weights carried across from the JAX package
(the port's copy of the AGCN and AAGCN maps of
agcn_tpu/utils/torch_export.py and of the npz/pickle branches of
agcn_tpu/train/checkpoint.load_checkpoint).

`agcn_state_dict_from_variables` and `aagcn_state_dict_from_variables`
turn a JAX `{"params", "batch_stats"}` tree of numpy arrays into the
port's state dict (the reference torch names), which the model's
`load_state_dict(..., strict=True)` accepts; `model_state_dict`
dispatches by model.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from agcn_tpu_torch.models.registry import model_key


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


def conv1d_to_torch(w) -> np.ndarray:
    """flax conv1d (k, in, out) -> torch (out, in, k)."""
    return np.transpose(_np(w), (2, 1, 0))


def _stats(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    stats = variables.get("batch_stats") or {}
    if not stats:
        raise ValueError(
            "the state dict needs batch_stats (BN running statistics); "
            "this checkpoint has none")
    return stats


def _head(out: Dict[str, np.ndarray], params: Mapping[str, Any],
          stats: Mapping[str, Any]) -> None:
    """data_bn (a BatchNorm, or AAGCN's LayerNorm: no statistics) and fc."""
    if "data_bn" in stats:
        _bn_out(out, "data_bn", params["data_bn"], stats["data_bn"])
    else:
        out["data_bn.weight"] = _np(params["data_bn"]["scale"])
        out["data_bn.bias"] = _np(params["data_bn"]["bias"])
    out["fc.weight"] = _np(params["fc"]["kernel"]).T
    out["fc.bias"] = _np(params["fc"]["bias"])


def _block_tail(out: Dict[str, np.ndarray], block: str,
                bp: Mapping[str, Any], bs: Mapping[str, Any]) -> None:
    """A block's GCN BN, down projection, TCN and residual: the same
    names in AGCN and AAGCN."""
    g, gs = bp["gcn1"], bs.get("gcn1", {})
    p = f"{block}.gcn1"
    _bn_out(out, f"{p}.bn", g["bn"], gs["bn"])
    if "down_conv" in g:
        out[f"{p}.down.0.weight"] = dense_to_pointwise(
            g["down_conv"]["conv"]["kernel"])
        out[f"{p}.down.0.bias"] = _np(g["down_conv"]["conv"]["bias"])
        _bn_out(out, f"{p}.down.1", g["down_bn"], gs["down_bn"])
    for unit in ("tcn1", "residual"):
        if unit in bp:
            out[f"{block}.{unit}.conv.weight"] = conv_to_torch(
                bp[unit]["conv"]["conv"]["kernel"])
            out[f"{block}.{unit}.conv.bias"] = _np(
                bp[unit]["conv"]["conv"]["bias"])
            _bn_out(out, f"{block}.{unit}.bn", bp[unit]["bn"],
                    bs[unit]["bn"])


def agcn_state_dict_from_variables(variables: Mapping[str, Any],
                                   num_subset: int = 3
                                   ) -> Dict[str, torch.Tensor]:
    """JAX AGCN variables -> the port's (reference-named) state dict."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    _head(out, params, stats)
    for block in sorted(k for k in params if k.startswith("l")):
        g = params[block]["gcn1"]
        p = f"{block}.gcn1"
        out[f"{p}.PA"] = _np(g["PA"])
        for k in range(num_subset):
            for role in ("a", "b", "d"):
                out[f"{p}.conv_{role}.{k}.weight"] = dense_to_pointwise(
                    g[f"conv_{role}{k}_kernel"])
                out[f"{p}.conv_{role}.{k}.bias"] = _np(
                    g[f"conv_{role}{k}_bias"])
        _block_tail(out, block, params[block], stats.get(block, {}))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def aagcn_state_dict_from_variables(variables: Mapping[str, Any],
                                    num_subset: int = 3,
                                    adaptive: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """JAX AAGCN variables -> the port's (reference-named) state dict
    (agcn_tpu/utils/torch_export.py:103-174)."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    _head(out, params, stats)
    for block in sorted(k for k in params if k.startswith("l")):
        g = params[block]["gcn1"]
        p = f"{block}.gcn1"
        a = g["agcn"]
        for k in range(num_subset):
            out[f"{p}.conv_d.{k}.weight"] = dense_to_pointwise(
                a[f"conv_d{k}_kernel"])
            out[f"{p}.conv_d.{k}.bias"] = _np(a[f"conv_d{k}_bias"])
            if adaptive:
                # the reference registers the unit's conv_d again inside
                # AdaptiveGCN (aagcn.py:228-233): both names, one weight
                out[f"{p}.agcn.conv_d.{k}.weight"] = \
                    out[f"{p}.conv_d.{k}.weight"]
                out[f"{p}.agcn.conv_d.{k}.bias"] = out[f"{p}.conv_d.{k}.bias"]
                for role in ("a", "b"):
                    out[f"{p}.agcn.conv_{role}.{k}.weight"] = \
                        dense_to_pointwise(a[f"conv_{role}{k}_kernel"])
                    out[f"{p}.agcn.conv_{role}.{k}.bias"] = _np(
                        a[f"conv_{role}{k}_bias"])
        if adaptive:
            out[f"{p}.agcn.PA"] = _np(a["PA"])
            out[f"{p}.agcn.alpha"] = _np(a["alpha"])
        if "attn_s" in g:
            for unit, conv in (("attn_s", "conv_sa"), ("attn_t", "conv_ta")):
                out[f"{p}.{unit}.{conv}.weight"] = conv1d_to_torch(
                    g[unit][conv]["kernel"])
                out[f"{p}.{unit}.{conv}.bias"] = _np(g[unit][conv]["bias"])
            for fc in ("fc1c", "fc2c"):
                out[f"{p}.attn_c.{fc}.weight"] = _np(
                    g["attn_c"][fc]["kernel"]).T
                out[f"{p}.attn_c.{fc}.bias"] = _np(g["attn_c"][fc]["bias"])
        _block_tail(out, block, params[block], stats.get(block, {}))
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


def model_state_dict(checkpoint: Mapping[str, Any], model: str = "agcn",
                     model_args: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The port's state dict of a recipe's `model` (short name or
    reference path) and `model_args` from what `load_checkpoint` read: a
    JAX variables tree is converted by the model's map, a reference state
    dict passes with DDP's `module.` prefix dropped (reference
    processor.py:242-249)."""
    if "params" in checkpoint:
        if model_key(model) == "aagcn":
            return aagcn_state_dict_from_variables(
                checkpoint, adaptive=(model_args or {}).get("adaptive",
                                                            True))
        return agcn_state_dict_from_variables(checkpoint)
    return {re.sub(r"^module\.", "", k): torch.as_tensor(v)
            for k, v in checkpoint.items()}
