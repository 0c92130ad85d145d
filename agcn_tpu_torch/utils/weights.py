"""Weights carried across from the JAX package
(the port's copy of the AGCN and AAGCN maps of
agcn_tpu/utils/torch_export.py, the transformer layer names of
agcn_tpu/utils/torch_import.py:412-445, and the npz/pickle branches of
agcn_tpu/train/checkpoint.load_checkpoint).

`agcn_state_dict_from_variables`, `aagcn_state_dict_from_variables`,
`aagcn_transformer_state_dict_from_variables`,
`aagcn_v{17,24,30,31,34}_state_dict_from_variables` (the inverses of
agcn_tpu/utils/torch_import.py:447-626),
`sgn_state_dict_from_variables` (agcn_tpu/utils/torch_export.py:260-500,
the keys of the port's SGN options, with those the JAX map leaves out) and
`sgn_original_state_dict_from_variables` (:177-224) and
`sgn_transformer_state_dict_from_variables` (:503-596, with the
torch-style encoder branch the JAX export refuses) turn a JAX `{"params",
"batch_stats"}` tree of numpy arrays into the port's state dict (the
reference torch names), which the model's `load_state_dict(...,
strict=True)` accepts; `model_state_dict` dispatches by the registry key.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from agcn_tpu_torch.models.registry import (model_key, unknown_model,
                                            waiting_item)
from agcn_tpu_torch.models.sgn import SEGMENT_PERIOD, linear_ffn_stacks


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


def _torch_tensors(out: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


_SCANNED = re.compile(r"l(\d+)_(\d+)")


def _leaf(tree: Any, i: int) -> Any:
    """Entry i of every leaf's leading axis."""
    if isinstance(tree, Mapping):
        return {k: _leaf(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def unstack_scanned_blocks(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A `scan_blocks` AGCN's params or batch_stats with each scanned
    group (`l2_4`: {"block": ...}, every leaf stacked on a leading axis,
    agcn_tpu/models/agcn.py:258-283) split into the unrolled model's
    blocks l2, l3, l4; other entries as they are."""
    out: Dict[str, Any] = {}
    for name, sub in tree.items():
        m = _SCANNED.fullmatch(name)
        if m is None:
            out[name] = sub
            continue
        for i, block in enumerate(range(int(m[1]), int(m[2]) + 1)):
            out[f"l{block}"] = _leaf(sub["block"], i)
    return out


def agcn_state_dict_from_variables(variables: Mapping[str, Any],
                                   num_subset: int = 3
                                   ) -> Dict[str, torch.Tensor]:
    """JAX AGCN variables -> the port's (reference-named) state dict. A
    `scan_blocks` model's stacked groups go into the blocks they stack."""
    variables = {k: unstack_scanned_blocks(v) if isinstance(v, Mapping)
                 else v for k, v in variables.items()}
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
    return _torch_tensors(out)


def _aagcn_blocks(out: Dict[str, np.ndarray], params: Mapping[str, Any],
                  stats: Mapping[str, Any], num_subset: int,
                  adaptive: bool) -> None:
    """AAGCN's blocks l1 .. l10 (agcn_tpu/utils/torch_export.py:103-174)."""
    for block in sorted(k for k in params if re.fullmatch(r"l\d+", k)):
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
    _aagcn_blocks(out, params, stats, num_subset, adaptive)
    return _torch_tensors(out)


def _linear_out(out: Dict[str, np.ndarray], prefix: str,
                dense: Mapping[str, Any]) -> None:
    """flax Dense {kernel (in, out), bias} -> torch Linear."""
    out[f"{prefix}.weight"] = _np(dense["kernel"]).T
    if "bias" in dense:
        out[f"{prefix}.bias"] = _np(dense["bias"])


def _layer_norm_out(out: Dict[str, np.ndarray], prefix: str,
                    norm: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _np(norm["scale"])
    if "bias" in norm:
        out[f"{prefix}.bias"] = _np(norm["bias"])


def _layer_out(out: Dict[str, np.ndarray], p: str,
               layer: Mapping[str, Any]) -> None:
    """A TransformerEncoderLayer with torch nn.TransformerEncoderLayer's
    names (torch_import.py:412-445: in_proj_weight is in_proj_kernel
    transposed; the biases of a bias-less layer absent; the forked MHA's
    relative position table as `self_attn.pos_emb.rel_pos_emb`)."""
    attn = layer["self_attn"]
    out[f"{p}.self_attn.in_proj_weight"] = _np(attn["in_proj_kernel"]).T
    if "in_proj_bias" in attn:
        out[f"{p}.self_attn.in_proj_bias"] = _np(attn["in_proj_bias"])
    _linear_out(out, f"{p}.self_attn.out_proj", attn["out_proj"])
    if "rel_pos" in attn:
        out[f"{p}.self_attn.pos_emb.rel_pos_emb"] = _np(
            attn["rel_pos"]["rel_pos_emb"])
    for lin in ("linear1", "linear2"):
        _linear_out(out, f"{p}.{lin}", layer[lin])
    for norm in ("norm1", "norm2"):
        _layer_norm_out(out, f"{p}.{norm}", layer[norm])


def _encoder_out(out: Dict[str, np.ndarray], prefix: str,
                 enc: Mapping[str, Any]) -> None:
    """A TransformerEncoder: the learned position table and each layerN."""
    if "pos_enc" in enc:
        out[f"{prefix}.pos_enc.embedding"] = _np(enc["pos_enc"]["embedding"])
    i = 1
    while f"layer{i}" in enc:
        _layer_out(out, f"{prefix}.layer{i}", enc[f"layer{i}"])
        i += 1


def _cross_fusion_out(out: Dict[str, np.ndarray], prefix: str,
                      cross: Mapping[str, Any]) -> None:
    """A CrossTransformer: a_attends_bN / b_attends_aN (to_q, to_k, to_v,
    to_out) and norm_aN / norm_bN."""
    for name, sub in cross.items():
        if name.startswith("norm_"):
            _layer_norm_out(out, f"{prefix}.{name}", sub)
        else:
            for lin in ("to_q", "to_k", "to_v", "to_out"):
                _linear_out(out, f"{prefix}.{name}.{lin}", sub[lin])


def aagcn_transformer_state_dict_from_variables(
        variables: Mapping[str, Any], num_subset: int = 3,
        adaptive: bool = True) -> Dict[str, torch.Tensor]:
    """JAX AAGCNTransformer variables -> the port's state dict: data BN
    and the blocks by the AAGCN map, the CLS tokens, each encoder,
    `cross_fusion`'s CLS cross-attention and LayerNorms, and fc."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    _head(out, params, stats)
    _aagcn_blocks(out, params, stats, num_subset, adaptive)
    for name in ("cls_token", "cls_token_t", "cls_token_s"):
        if name in params:
            out[name] = _np(params[name])
    for name in ("encoder", "temporal_encoder", "spatial_encoder"):
        if name in params:
            _encoder_out(out, name, params[name])
    if "cross_fusion" in params:
        _cross_fusion_out(out, "cross_fusion", params["cross_fusion"])
    return _torch_tensors(out)


def _version_head(variables: Mapping[str, Any]):
    """(params, out) with a version's data norm, its adaptive backbone's
    blocks and fc (torch_import.py:447-460: the AAGCN map)."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    _head(out, params, stats)
    _aagcn_blocks(out, params, stats, 3, True)
    return params, out


def _copy(out: Dict[str, np.ndarray], params: Mapping[str, Any],
          pairs) -> None:
    """`out[torch name] = params[flax path]` for the (torch name, flax
    path) pairs whose path the tree has."""
    for name, path in pairs:
        node = params
        for part in path:
            if not isinstance(node, Mapping) or part not in node:
                break
            node = node[part]
        else:
            out[name] = _np(node)


def _layers_out(out: Dict[str, np.ndarray], params: Mapping[str, Any],
                flax_prefix: str, torch_prefix: str) -> None:
    """Layers `{flax_prefix}{i}` -> `{torch_prefix}.{i}`, i = 0, 1, ..."""
    i = 0
    while f"{flax_prefix}{i}" in params:
        _layer_out(out, f"{torch_prefix}.{i}", params[f"{flax_prefix}{i}"])
        i += 1


def _spatial_out(out: Dict[str, np.ndarray],
                 params: Mapping[str, Any]) -> None:
    """v31 / v34's spatial layers: `s_layer{i}`, or the subset layers
    `s_layer{i}_subset{a}` with their `s_layer{i}_PA{a}` and
    `s_layer{i}_alpha{a}`, and v34 v3's `sa_norm{i}`
    (torch_import.py:562-579, 609-625)."""
    i = 0
    while f"s_layer{i}" in params or f"s_layer{i}_subset0" in params:
        p = f"s_trans_enc_layers.{i}"
        if f"s_layer{i}" in params:
            _layer_out(out, p, params[f"s_layer{i}"])
        a = 0
        while f"s_layer{i}_subset{a}" in params:
            _layer_out(out, f"{p}.subset{a}", params[f"s_layer{i}_subset{a}"])
            _copy(out, params, ((f"{p}.subset{a}.PA", (f"s_layer{i}_PA{a}",)),
                                (f"{p}.subset{a}.alpha",
                                 (f"s_layer{i}_alpha{a}",))))
            a += 1
        if f"sa_norm{i}" in params:
            _layer_norm_out(out, f"{p}.sa_norm", params[f"sa_norm{i}"])
        i += 1


def _norms_out(out: Dict[str, np.ndarray], params: Mapping[str, Any],
               names) -> None:
    for name in names:
        if name in params:
            _layer_norm_out(out, name, params[name])


def aagcn_v17_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AAGCNv17 variables -> the port's state dict (the inverse of
    torch_import.aagcn_v17_variables_from_torch, :447-460)."""
    params, out = _version_head(variables)
    _copy(out, params, (("cls_token", ("cls_token",)),
                        ("pos_encoder.pe", ("pos_encoder", "pe"))))
    _layers_out(out, params, "layer", "trans_enc")
    return _torch_tensors(out)


def aagcn_v24_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AAGCNv24 variables -> the port's state dict (the inverse of
    torch_import.aagcn_v24_variables_from_torch, :506-526)."""
    params, out = _version_head(variables)
    _copy(out, params, (("s_cls_token", ("s_cls_token",)),
                        ("s_pos_encoder.pe", ("s_pos_encoder", "pe")),
                        ("alpha", ("alpha",))))
    _layers_out(out, params, "s_layer", "s_trans_enc_layers")
    i = 0
    while f"s_layer{i}" in params:
        _copy(out, params, ((f"s_trans_enc_layers.{i}.PA",
                             (f"s_layer{i}_PA",)),))
        i += 1
    return _torch_tensors(out)


def aagcn_v30_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AAGCNv30 variables -> the port's state dict (the inverse of
    torch_import.aagcn_v30_variables_from_torch, :463-503): the
    GCNUnitLocal's conv_d under the unit, the rest under `agcn`."""
    params, out = _version_head(variables)
    stats = _stats(variables)
    _copy(out, params, (("cls_token", ("cls_token",)),
                        ("t_pos_encoder.pe", ("t_pos_encoder", "pe"))))
    _layers_out(out, params, "t_layer", "t_trans_enc_layers")
    i = 0
    while f"s_layer{i}" in params:
        unit, p = params[f"s_layer{i}"], f"s_trans_enc_layers.{i}"
        agcn = unit["agcn"]
        out[f"{p}.agcn.PA"] = _np(agcn["PA"])
        out[f"{p}.agcn.alpha"] = _np(agcn["alpha"])
        k = 0
        while f"conv_a{k}" in agcn:
            for role, prefix in (("a", f"{p}.agcn.conv_a"),
                                 ("b", f"{p}.agcn.conv_b"),
                                 ("d", f"{p}.conv_d")):
                conv = agcn[f"conv_{role}{k}"]["conv"]
                out[f"{prefix}.{k}.weight"] = dense_to_pointwise(
                    conv["kernel"])
                out[f"{prefix}.{k}.bias"] = _np(conv["bias"])
            k += 1
        _bn_out(out, f"{p}.bn", unit["bn"], stats[f"s_layer{i}"]["bn"])
        i += 1
    return _torch_tensors(out)


def aagcn_v31_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AAGCNv31 (v31 and v32) variables -> the port's state dict (the
    inverse of torch_import.aagcn_v31_variables_from_torch, :582-626):
    the shared alpha `sa_alpha` is the reference's `alpha`."""
    params, out = _version_head(variables)
    _copy(out, params, (("cls_token", ("cls_token",)),
                        ("t_pos_encoder.pe", ("t_pos_encoder", "pe")),
                        ("alpha", ("sa_alpha",))))
    _norms_out(out, params, ("sa_norm", "res_norm"))
    _layers_out(out, params, "t_layer", "t_trans_enc_layers")
    _spatial_out(out, params)
    return _torch_tensors(out)


def aagcn_v34_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AAGCNv34 variables -> the port's state dict (the inverse of
    torch_import.aagcn_v34_variables_from_torch, :529-579)."""
    params, out = _version_head(variables)
    _copy(out, params, (("cls_token", ("cls_token",)),
                        ("t_pos_encoder.pe", ("t_pos_encoder", "pe"))))
    _norms_out(out, params, ("sa_norm", "res_norm"))
    if "cls_pool_fc" in params:
        _linear_out(out, "cls_pool_fc", params["cls_pool_fc"])
    _layers_out(out, params, "t_layer", "t_trans_enc_layers")
    _spatial_out(out, params)
    return _torch_tensors(out)


_VERSION_MAPS = {"aagcn_v17": aagcn_v17_state_dict_from_variables,
                 "aagcn_v24": aagcn_v24_state_dict_from_variables,
                 "aagcn_v30": aagcn_v30_state_dict_from_variables,
                 "aagcn_v31": aagcn_v31_state_dict_from_variables,
                 "aagcn_v32": aagcn_v31_state_dict_from_variables,
                 "aagcn_v34": aagcn_v34_state_dict_from_variables}


def _torch_conv_weight(kernel) -> np.ndarray:
    """A flax SGN kernel -> torch: 2-D dense (in, out) -> (out, in, 1, 1);
    4-D (k, 1, in, out), k along T -> the reference's (out, in, 1, k)."""
    k = _np(kernel)
    return dense_to_pointwise(k) if k.ndim == 2 else np.transpose(
        k, (3, 2, 1, 0))


def _sgn_conv_out(out: Dict[str, np.ndarray], prefix: str,
                  conv: Mapping[str, Any]) -> None:
    """A flax Dense/Conv -> the reference Conv's `block.conv.conv`."""
    out[f"{prefix}.block.conv.conv.weight"] = _torch_conv_weight(
        conv["kernel"])
    if "bias" in conv:
        out[f"{prefix}.block.conv.conv.bias"] = _np(conv["bias"])


def _sgn_embedding_out(out: Dict[str, np.ndarray], prefix: str,
                       node: Mapping[str, Any],
                       stats: Mapping[str, Any]) -> None:
    """An SGNEmbedding: the DataNorm, `cnn{i}` and (embedding mode 2, the
    port's own names: the reference export has none) `res{i}`."""
    if "in_norm" in node:
        _bn_out(out, f"{prefix}.norm.bn", node["in_norm"], stats["in_norm"])
    i = 1
    while f"cnn{i}" in node:
        _sgn_conv_out(out, f"{prefix}.cnn{i}", node[f"cnn{i}"]["cnn"]["conv"])
        if f"res{i}" in node:
            _linear_out(out, f"{prefix}.res{i}", node[f"res{i}"])
        i += 1


def _onehot_buffer(dim_eye: int, dim_length: int, mode: int) -> np.ndarray:
    """The reference OneHotTensor buffer (blocks/semantic.py:128-146):
    eye(dim_eye) tiled to (1, dim_length, E, E), then mode-permuted, the
    class table (mode 2) as tiled (torch_export.py:274-286)."""
    oh = np.broadcast_to(np.eye(dim_eye, dtype=np.float32),
                         (1, dim_length, dim_eye, dim_eye))
    if mode == 0:
        oh = oh.transpose(0, 3, 2, 1)
    elif mode == 1:
        oh = oh.transpose(0, 3, 1, 2)
    return np.array(oh, order="C")


def _vc_to_cv(w: np.ndarray, num_point: int) -> np.ndarray:
    """A kernel whose input features (axis -2) are (v, c)-flattened, as
    the JAX model flattens a frame's joints, in the reference's (c, v)
    order (torch_export.py:300-307)."""
    *lead, cin_all, out = w.shape
    w = w.reshape(*lead, num_point, cin_all // num_point, out)
    return np.ascontiguousarray(np.swapaxes(w, -3, -2)).reshape(
        *lead, cin_all, out)


def _sgn_g_module_out(out: Dict[str, np.ndarray], p: str,
                       g: Mapping[str, Any], gs: Mapping[str, Any],
                       num_point: int) -> None:
    """A G module: its projections g1-g4, GT2's Linear `g3` or GT3 /
    GT4's MLP `g3` (the first layer of either reads the (c, v)-flattened
    joint features), GT5 / GT6's `tem_embedding` with its one-hot buffer
    and GT5's head `g3_cnn{i}` as `g3.cnn{i}`, and `alpha`
    (torch_export.py:365-415)."""
    for name in ("g1", "g2", "g3", "g4"):
        if name in g and "conv" in g[name]:
            _sgn_conv_out(out, f"{p}.{name}", g[name]["conv"])
    g3 = g.get("g3", {})
    if "kernel" in g3:
        _linear_out(out, f"{p}.g3", dict(
            g3, kernel=_vc_to_cv(_np(g3["kernel"]), num_point)))
    li = 1
    while f"cnn{li}" in g3:
        node = g3[f"cnn{li}"]
        conv = node["conv"] if "conv" in node else node["cnn"]["conv"]
        if li == 1:
            conv = dict(conv, kernel=_vc_to_cv(_np(conv["kernel"]),
                                               num_point))
        _sgn_conv_out(out, f"{p}.g3.cnn{li}", conv)
        if "norm" in node:
            _bn_out(out, f"{p}.g3.cnn{li}.block.norm", node["norm"],
                    gs["g3"][f"cnn{li}"]["norm"])
        li += 1
    if "tem_embedding" in g:
        emb = g["tem_embedding"]
        _sgn_embedding_out(out, f"{p}.tem_embedding", emb,
                           gs.get("tem_embedding", {}))
        out[f"{p}.tem_onehot.onehot"] = _onehot_buffer(
            int(np.shape(emb["cnn1"]["cnn"]["conv"]["kernel"])[-2]), 1,
            mode=1)
    li = 1
    while f"g3_cnn{li}" in g:
        _sgn_block_out(out, f"{p}.g3.cnn{li}", g[f"g3_cnn{li}"],
                       gs[f"g3_cnn{li}"])
        li += 1
    out[f"{p}.alpha"] = _np(g["alpha"])


def _sgn_block_out(out: Dict[str, np.ndarray], p: str,
                   node: Mapping[str, Any], snode: Mapping[str, Any],
                   linear: bool = False) -> None:
    """A ConvNormAct: its conv [as a `LinearLayer`] and its BN."""
    conv = node["cnn"]["conv"]
    if linear:
        _linear_out(out, f"{p}.block.linear.linear", conv)
    else:
        _sgn_conv_out(out, p, conv)
    if "norm" in node:
        _bn_out(out, f"{p}.block.norm", node["norm"], snode["norm"])


def _sgn_stack_out(out: Dict[str, np.ndarray], p: str,
                   sg: Mapping[str, Any], sgs: Mapping[str, Any],
                   num_point: int, linear_ffn: bool) -> None:
    """A GCN stack (`sgcn`, `sgcn2`; torch_export.py:359-470): its G
    modules `gcn_g{i}`, units `gcn{i}` (w0-w3, res_alpha, norm), and
    `gcn_prenorm{i}`, `gcn_ffn{i}` (the "Linear" variants' keys with
    `linear_ffn`) and `gcn_res{i}`."""
    i = 1
    while f"g{i}" in sg:
        _sgn_g_module_out(out, f"{p}.gcn_g{i}", sg[f"g{i}"],
                          sgs.get(f"g{i}", {}), num_point)
        i += 1
    i = 1
    while f"gcn{i}" in sg:
        n, u = sg[f"gcn{i}"], f"{p}.gcn{i}"
        for name in ("w0", "w1", "w2", "w3"):
            if name in n:
                _sgn_conv_out(out, f"{u}.{name}", n[name].get("conv", n[name]))
        if "res_alpha" in n:
            out[f"{u}.res_alpha"] = _np(n["res_alpha"])
        if "norm" in n:
            _bn_out(out, f"{u}.norm", n["norm"], sgs[f"gcn{i}"]["norm"])
        if f"prenorm{i}" in sg:
            _bn_out(out, f"{p}.gcn_prenorm{i}", sg[f"prenorm{i}"],
                    sgs[f"prenorm{i}"])
        if f"ffn{i}" in sg:
            fn, fns, fp = sg[f"ffn{i}"], sgs[f"ffn{i}"], f"{p}.gcn_ffn{i}"
            for name in ("ffn1", "ffn2"):
                _sgn_block_out(out, f"{fp}.{name}", fn[name],
                               fns.get(name, {}), linear_ffn)
            if "norm" in fn:
                _bn_out(out, f"{fp}.norm", fn["norm"], fns["norm"])
        if f"res{i}" in sg:
            _sgn_conv_out(out, f"{p}.gcn_res{i}", sg[f"res{i}"]["conv"])
        i += 1


def _sgn_mlp_out(out: Dict[str, np.ndarray], p: str,
                 node: Mapping[str, Any], snode: Mapping[str, Any]) -> None:
    """A temporal MLP: `cnn1`, `cnn2` (each BN before its conv under
    prenorm, under the same key) and (t_mode 2 across widths, the JAX
    module's name) the 1x1 conv `res2`."""
    for layer in ("cnn1", "cnn2"):
        _sgn_block_out(out, f"{p}.{layer}", node[layer], snode[layer])
    if "res2" in node:
        conv = node["res2"]["conv"]
        out[f"{p}.res2.conv.weight"] = _torch_conv_weight(conv["kernel"])
        if "bias" in conv:
            out[f"{p}.res2.conv.bias"] = _np(conv["bias"])


def _aspp_out(out: Dict[str, np.ndarray], p: str, node: Mapping[str, Any],
              snode: Mapping[str, Any]) -> None:
    """An `ops/blocks.ASPP` under the JAX module's names: Dense -> Linear,
    the dilated (k, 1) convs -> Conv2d (out, in, k, 1), the BNs."""
    for name, sub in node.items():
        if name.startswith("bn"):
            _bn_out(out, f"{p}.{name}", sub, snode[name])
        elif name.startswith("branch_d"):
            out[f"{p}.{name}.weight"] = conv_to_torch(sub["kernel"])
            if "bias" in sub:
                out[f"{p}.{name}.bias"] = _np(sub["bias"])
        else:
            _linear_out(out, f"{p}.{name}", sub)


def _bifpn_out(out: Dict[str, np.ndarray], p: str, node: Mapping[str, Any],
               snode: Mapping[str, Any]) -> None:
    """An `ops/blocks.BiFPN` under the JAX module's names: `in_proj{i}`,
    `in_bn{i}`, and each `block{l}`'s `w_td`, `w_bu`, `td{i}` / `bu{i}`
    and their BNs."""
    for name, sub in node.items():
        if name.startswith("block"):
            for inner, leaf in sub.items():
                if inner in ("w_td", "w_bu"):
                    out[f"{p}.{name}.{inner}"] = _np(leaf)
                elif inner.endswith("_bn"):
                    _bn_out(out, f"{p}.{name}.{inner}", leaf,
                            snode[name][inner])
                else:
                    _linear_out(out, f"{p}.{name}.{inner}", leaf)
        elif name.startswith("in_bn"):
            _bn_out(out, f"{p}.{name}", sub, snode[name])
        else:
            _linear_out(out, f"{p}.{name}", sub)


def sgn_state_dict_from_variables(variables: Mapping[str, Any],
                                  num_point: int = 25,
                                  num_segment: int = 20,
                                  linear_ffn: Sequence[str] = ()
                                  ) -> Dict[str, torch.Tensor]:
    """JAX SGN variables -> the port's (reference sgn_v14-named) state
    dict, for the options the port builds (torch_export.py:260-500). The
    one-hot buffers' sizes, and the joints of the (c, v) reorders, come
    from the joint and frame embeddings' input widths, as in the JAX map
    (the 8 part nodes under the segment embeddings, whose parts `seg{i}`
    go to `feature_extractor.{pos,vel}_embed.{i}`, torch_export.py:
    330-341). Beyond the JAX map's keys it writes the input side's
    `semantic_embedding.jdiff_embedding` (JAX `jdiff_embed`),
    `x_emb_projection` and `semantic_embedding.joint_smp_embedding`
    (`joint_smp_embed`), the GCN-FPN's projections
    `fpn_proj{i}[_k{k}]`, the InfoGCN head's `fc_mu` and `fc_logvar` and
    its buffer `z_prior`, which the JAX export leaves out, and, under the
    JAX module names (the JAX export has none), the temporal branches'
    `aspp`, `mha` (`layerN` as the AAGCN transformer's),
    `cnn_{raw,season,trend}`, `cnn_p{k}` and `res2`, the BiFPN `bifpn`,
    the pools' `smp{i}_{k,1x1}_{conv,bn}`, `tmp_{k,1x1}_{conv,bn}` and
    `tmp_ind_projection`. `linear_ffn` (the JAX map's flag, a stack at a
    time): the stacks ("sgcn", "sgcn2") whose FFN is a "Linear" variant
    (`models/sgn.linear_ffn_stacks`), whose layers the map writes as
    `.block.linear.linear.*`."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    segments = False
    for flax_name, prefix in (
            ("pos_embed", "feature_extractor.pos_embed"),
            ("vel_embed", "feature_extractor.vel_embed"),
            ("joint_embed", "semantic_embedding.spa_embedding"),
            ("jdiff_embed", "semantic_embedding.jdiff_embedding"),
            ("x_emb_projection", "x_emb_projection"),
            ("frame_embed", "semantic_embedding.tem_embedding"),
            ("class_embed", "semantic_embedding.cls_embedding"),
            ("joint_smp_embed", "semantic_embedding.joint_smp_embedding")):
        node, snode = params.get(flax_name), stats.get(flax_name, {})
        if node is not None and "seg0" in node:  # the segment embeddings
            for i in range(len(node)):
                _sgn_embedding_out(out, f"{prefix}.{i}", node[f"seg{i}"],
                                   snode[f"seg{i}"])
            num_point, segments = len(node), True
        elif node is not None:
            _sgn_embedding_out(out, prefix, node, snode)

    def in_dim(node):
        return int(np.shape(node["cnn1"]["cnn"]["conv"]["kernel"])[-2])

    if "joint_embed" in params:
        num_point = in_dim(params["joint_embed"])
    if "frame_embed" in params:
        num_segment = in_dim(params["frame_embed"])
    elif segments:  # the windows of the loader's num_segment frames
        num_segment //= SEGMENT_PERIOD
    if "joint_embed" in params:
        out["semantic_embedding.spa_onehot.onehot"] = _onehot_buffer(
            num_point, num_segment, mode=0)
    if "frame_embed" in params:
        out["semantic_embedding.tem_onehot.onehot"] = _onehot_buffer(
            num_segment, num_point, mode=1)
    if "class_embed" in params:
        out["semantic_embedding.cls_onehot.onehot"] = _onehot_buffer(
            in_dim(params["class_embed"]), 1, mode=2)

    for stack in ("sgcn", "sgcn2"):
        if stack in params:
            _sgn_stack_out(out, stack, params[stack], stats.get(stack, {}),
                           num_point, stack in linear_ffn)

    for name in params:
        m = re.fullmatch(r"tem(\d+)_(\d+)_k(\d+)", name)
        if m:  # the temporal branches tem{i}_{j}_k{k}
            p = f"tem_mlp_{m[1]}_{m[2]}_k{m[3]}"
            snode = stats.get(name, {})
            for sub, node in params[name].items():
                if sub == "aspp":
                    _aspp_out(out, f"{p}.aspp", node, snode["aspp"])
                elif sub == "mha":
                    _encoder_out(out, f"{p}.mha", node)
                else:  # cnn, cnn_raw / _season / _trend, cnn_p{k}
                    _sgn_mlp_out(out, f"{p}.{sub}", node, snode[sub])
        elif re.fullmatch(r"fpn_proj\d+(_k\d+)?", name):
            _sgn_conv_out(out, name, params[name]["conv"])
        elif name == "bifpn":
            _bifpn_out(out, name, params[name], stats["bifpn"])
        elif re.fullmatch(r"(smp\d+|tmp)_(k|1x1)_conv", name):
            out[f"{name}.weight"] = conv_to_torch(params[name]["kernel"])
            if "bias" in params[name]:
                out[f"{name}.bias"] = _np(params[name]["bias"])
        elif re.fullmatch(r"(smp\d+|tmp)_(k|1x1)_bn", name):
            _bn_out(out, name, params[name], stats[name])
        elif name == "tmp_ind_projection":
            _sgn_block_out(out, name, params[name], {})
        elif re.fullmatch(r"fc\d+", name):
            _linear_out(out, name, params[name])
    for name in ("fc_mu", "fc_logvar", "fc"):
        if name in params:
            _linear_out(out, name, params[name])
    if "z_prior" in stats:
        out["z_prior"] = _np(stats["z_prior"])
    return _torch_tensors(out)


def sgn_original_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SGNOriginal variables -> the original microsoft/SGN state dict
    (the port's copy of torch_export.sgn_original_state_dict_from_variables,
    agcn_tpu/utils/torch_export.py:177-224)."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}

    def dense(node, prefix):
        out[f"{prefix}.weight"] = dense_to_pointwise(node["kernel"])
        if "bias" in node:
            out[f"{prefix}.bias"] = _np(node["bias"])

    for flax_name, prefix, normed in (("pos_embed", "joint_embed", True),
                                      ("dif_embed", "dif_embed", True),
                                      ("spa_embed", "spa_embed", False),
                                      ("tem_embed", "tem_embed", False)):
        node = params[flax_name]
        i = 0
        if normed:
            _bn_out(out, f"{prefix}.cnn.0.bn", node["in_norm"],
                    stats[flax_name]["in_norm"])
            i = 1
        dense(node["cnn1"]["conv"], f"{prefix}.cnn.{i}.cnn")
        dense(node["cnn2"]["conv"], f"{prefix}.cnn.{i + 2}.cnn")
    dense(params["g1"]["conv"], "compute_g1.g1.cnn")
    dense(params["g2"]["conv"], "compute_g1.g2.cnn")
    for i in (1, 2, 3):
        node = params[f"gcn{i}"]
        dense(node["w"], f"gcn{i}.w.cnn")
        dense(node["w1"]["conv"], f"gcn{i}.w1.cnn")
        _bn_out(out, f"gcn{i}.bn", node["norm"], stats[f"gcn{i}"]["norm"])
    # the local conv is (1, 3) over the time axis: (out, in, 1, 3)
    out["cnn.cnn1.weight"] = np.transpose(_np(params["t_cnn1"]["kernel"]),
                                          (3, 2, 1, 0))
    if "bias" in params["t_cnn1"]:
        out["cnn.cnn1.bias"] = _np(params["t_cnn1"]["bias"])
    _bn_out(out, "cnn.bn1", params["t_norm1"], stats["t_norm1"])
    dense(params["t_cnn2"]["conv"], "cnn.cnn2")
    _bn_out(out, "cnn.bn2", params["t_norm2"], stats["t_norm2"])
    _linear_out(out, "fc", params["fc"])
    return _torch_tensors(out)


def _channel_norm_out(out: Dict[str, np.ndarray], prefix: str,
                      node: Mapping[str, Any],
                      stats: Optional[Mapping[str, Any]]) -> None:
    """A lucid encoder's ChannelNorm: the BatchNorm (running statistics)
    or the LayerNorm under its `norm`."""
    sn = (stats or {}).get("norm", {})
    if "mean" in sn:
        _bn_out(out, prefix, node["norm"], sn)
    else:
        _layer_norm_out(out, prefix, node["norm"])


def _lucid_out(out: Dict[str, np.ndarray], prefix: str,
               node: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    """A LucidTransformer under the reference's `<encoder>.transformer`
    (torch_export.py:566-591)."""
    i = 1
    while f"l{i}_attn" in node:
        base = f"{prefix}.transformer.layers.l{i}"
        for part in ("attn", "ffn"):
            _channel_norm_out(out, f"{base}.{part}.norm.fn",
                              node[f"l{i}_{part}_norm"],
                              stats.get(f"l{i}_{part}_norm"))
        at = node[f"l{i}_attn"]
        for lin in ("to_q", "to_k", "to_v"):
            _linear_out(out, f"{base}.attn.fn.{lin}", at[lin])
        _linear_out(out, f"{base}.attn.fn.to_out.linear", at["to_out"])
        ff = node[f"l{i}_ffn"]
        _linear_out(out, f"{base}.ffn.fn.net.linear1", ff["linear1"])
        _linear_out(out, f"{base}.ffn.fn.net.linear2", ff["linear2"])
        for part, sub in (("attn", at), ("ffn", ff)):
            if "residual" in sub:
                _linear_out(out, f"{base}.{part}.fn.residual",
                            sub["residual"])
        i += 1
    if "global_norm" in node:
        _channel_norm_out(out, f"{prefix}.transformer.norm.fn",
                          node["global_norm"], stats.get("global_norm"))


def sgn_transformer_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SGNTransformer variables -> the port's (reference
    sgn_v15-named) state dict (torch_export.py:503-596): the embeddings
    and one-hot buffers as in SGN's map, each encoder by its branch (the
    lucid encoder under `<encoder>.transformer`, the torch-style stack's
    `layerN` by the AAGCN transformer's names, which the JAX export
    refuses), and fc."""
    params = variables["params"]
    stats = _stats(variables)
    out: Dict[str, np.ndarray] = {}
    for flax_name, prefix in (
            ("pos_embed", "feature_extractor.pos_embed"),
            ("vel_embed", "feature_extractor.vel_embed"),
            ("joint_embed", "semantic_embedding.spa_embedding"),
            ("frame_embed", "semantic_embedding.tem_embedding"),
            ("class_embed", "semantic_embedding.cls_embedding")):
        if flax_name in params:
            _sgn_embedding_out(out, prefix, params[flax_name],
                               stats.get(flax_name, {}))

    def in_dim(node):
        return int(np.shape(node["cnn1"]["cnn"]["conv"]["kernel"])[-2])

    num_point = (in_dim(params["joint_embed"]) if "joint_embed" in params
                 else 25)
    num_segment = (in_dim(params["frame_embed"]) if "frame_embed" in params
                   else 20)
    if "joint_embed" in params:
        out["semantic_embedding.spa_onehot.onehot"] = _onehot_buffer(
            num_point, num_segment, mode=0)
    if "frame_embed" in params:
        out["semantic_embedding.tem_onehot.onehot"] = _onehot_buffer(
            num_segment, num_point, mode=1)
    if "class_embed" in params:
        out["semantic_embedding.cls_onehot.onehot"] = _onehot_buffer(
            in_dim(params["class_embed"]), 1, mode=2)
    for mha in ("spatial_mha", "temporal_mha"):
        node = params[mha]
        if any(k.startswith("layer") for k in node):
            _encoder_out(out, mha, node)
        else:
            _lucid_out(out, mha, node, stats.get(mha, {}))
    _linear_out(out, "fc", params["fc"])
    return _torch_tensors(out)


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
    processor.py:242-249). A JAX tree of a model without a map raises."""
    if "params" in checkpoint:
        key = model_key(model)
        adaptive = (model_args or {}).get("adaptive", True)
        if key == "agcn":
            return agcn_state_dict_from_variables(checkpoint)
        if key == "aagcn":
            return aagcn_state_dict_from_variables(checkpoint,
                                                   adaptive=adaptive)
        if key == "aagcn_transformer":
            return aagcn_transformer_state_dict_from_variables(
                checkpoint, adaptive=adaptive)
        if key == "sgn":
            return sgn_state_dict_from_variables(
                checkpoint, linear_ffn=linear_ffn_stacks(model_args or {}))
        if key == "sgn_original":
            return sgn_original_state_dict_from_variables(checkpoint)
        if key == "sgn_transformer":
            return sgn_transformer_state_dict_from_variables(checkpoint)
        if key in _VERSION_MAPS:
            return _VERSION_MAPS[key](checkpoint)
        item = waiting_item(model)
        if item is None:
            raise unknown_model(model)
        raise NotImplementedError(
            f"a JAX checkpoint of model {model!r}: the port has no weight "
            f"map for it; it waits in ROADMAP {item}")
    return {re.sub(r"^module\.", "", k): torch.as_tensor(v)
            for k, v in checkpoint.items()}
