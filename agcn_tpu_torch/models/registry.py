"""Model registry (port of agcn_tpu/models/registry.py: AGCN, AAGCN, the
AAGCN transformer, the AAGCN versions v17/v24/v30/v31/v32/v34, SGN, the
original SGN and SGN's transformer, v15): every model the JAX package
builds.

Models are selected by short name; the reference's dotted paths for the
ported models are aliased so its config files work unchanged. Graph
construction (the `graph`/`graph_args` model args) resolves through
agcn_tpu_torch.graph. Any other dotted path that does not start with
`model.` is a user plug-in: the torch `nn.Module` class (or factory) it
names is imported and built with `cls(**model_args)`, as the JAX package
builds a flax one (`import_class`, agcn_tpu/models/registry.py:80-87,
210-212). A name the JAX package does not build raises KeyError, as in
the JAX package; `_WAITING` would list a JAX model that
the port lacked, with the ROADMAP item it waits in (none is left).
`edge_mesh` (a parallel.Mesh) reaches AGCN and AAGCN only; the other
models, the SGN names and unaliased dotted paths raise JAX's ValueError.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from agcn_tpu_torch.graph import build_adjacency
from agcn_tpu_torch.models.aagcn import AAGCN
from agcn_tpu_torch.models.aagcn_transformer import AAGCNTransformer
from agcn_tpu_torch.models.aagcn_versions import VERSIONS, AAGCNv31
from agcn_tpu_torch.models.agcn import AGCN
from agcn_tpu_torch.models.sgn import SGN
from agcn_tpu_torch.models.sgn_original import SGNOriginal
from agcn_tpu_torch.models.sgn_transformer import SGNTransformer
from agcn_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_SGN_VERSIONS = ("v11", "v12", "v13", "v14")
_ALIASES = {
    "model.agcn.Model": "agcn",
    "model.aagcn.Model": "aagcn",
    "model.architecture.aagcn.agcn.Model": "agcn",
    "model.architecture.aagcn.aagcn.Model": "aagcn",
    "model.aagcn_v37.Model": "aagcn_transformer",
    "model.architecture.aagcn.aagcn_v37.Model": "aagcn_transformer",
    **{f"model.sgn_{v}.SGN": "sgn" for v in _SGN_VERSIONS},
    **{f"model.architecture.sgn.sgn_{v}.SGN": "sgn" for v in _SGN_VERSIONS},
    # the original microsoft/SGN (agcn_tpu/models/registry.py:37-40)
    "model.sgn.SGN": "sgn_original",
    "model.architecture.sgn.sgn.SGN": "sgn_original",
    "model.architecture.sgn.archiv.sgn.SGN": "sgn_original",
    # the pure-transformer SGN (agcn_tpu/models/registry.py:41-43)
    "model.sgn_v15.SGN": "sgn_transformer",
    "model.architecture.sgn.sgn_v15.SGN": "sgn_transformer",
    # the version-faithful variants (models/aagcn_versions.py)
    **{f"{prefix}aagcn_v{n}.Model": f"aagcn_v{n}"
       for n in (17, 24, 30, 31, 32, 34)
       for prefix in ("model.", "model.architecture.aagcn.")},
}
# aagcn_v32 is v31 with version='v32' (per-layer alphas, the 'attn-a'
# modes, bias-less layers)
_CLASSES = {"agcn": AGCN, "aagcn": AAGCN,
            "aagcn_transformer": AAGCNTransformer, "sgn": SGN,
            "sgn_original": SGNOriginal, "sgn_transformer": SGNTransformer,
            "aagcn_v32": AAGCNv31, **VERSIONS}
# the keys and aliases the JAX package builds (agcn_tpu/models/
# registry.py:21-55, 89-199) that the port lacks, each with the ROADMAP
# item it waits in: none since SGN's transformer (Queue 1 item 7.3)
_WAITING: Dict[str, str] = {}
# reference-only SGN args the model fixes or that are dead upstream
# (agcn_tpu/models/registry.py:172-184): norm/act are fixed bn+relu,
# semantic_frame_fusion is unused in the reference (sgn_v14.py:258), the
# sgcn2 G/GT args are dead in its forward
_SGN_DROPPED = ("norm_type", "act_type", "semantic_frame_fusion",
                "semantic_class_fusion", "sgcn2_g_kernel", "sgcn2_g_proj_dim",
                "sgcn2_g_proj_shared", "sgcn2_g_weighted",
                "sgcn2_g_res_alpha", "sgcn2_gt_mode", "sgcn2_gt_act",
                "sgcn2_gt_g3_idx", "sgcn_ffn_mode")


def model_key(name: str) -> str:
    """The registry key of a recipe's `model` (a short name or a reference
    dotted path)."""
    return _ALIASES.get(name, name).lower()


def waiting_item(name: str) -> Optional[str]:
    """The ROADMAP item a model of the JAX package that the port lacks
    waits in (None for a ported name, or one the JAX package refuses)."""
    return _WAITING.get(name) or _WAITING.get(name.lower())


def unknown_model(name: str) -> KeyError:
    """The JAX package's KeyError for a name it does not build
    (agcn_tpu/models/registry.py:200-213): its own message for an
    unaliased reference path (an archived experiment)."""
    if "." in name and name.startswith("model."):
        supported = sorted(k for k in list(_ALIASES) + list(_WAITING)
                           if k.startswith("model."))
        return KeyError(
            f"{name!r} is an archived reference experiment with no "
            f"equivalent here; supported reference paths: {supported}")
    return KeyError(f"Unknown model {name!r}")


def sgn_args(model_args: Dict[str, Any]) -> Dict[str, Any]:
    """A recipe's SGN `model_args` in the model's names
    (agcn_tpu/models/registry.py:160-199): `bias` -> `use_bias`, the
    reference-only names dropped, tuples for `sgcn_dims` / `multi_t` /
    `sgcn_residual`, a scalar `c_multiplier` for all four widths."""
    args = dict(model_args)
    if "bias" in args:
        args["use_bias"] = args.pop("bias")
    if "use_bias" in args:
        args["use_bias"] = bool(args["use_bias"])
    for k in _SGN_DROPPED:
        args.pop(k, None)
    for k in ("sgcn_dims", "sgcn2_dims"):
        if args.get(k) is not None:
            args[k] = tuple(args[k])
    if "sgcn_residual" in args:
        r = args["sgcn_residual"]
        args["sgcn_residual"] = tuple(r) if isinstance(r, (list, tuple)) \
            else (r,) * 3
    if "multi_t" in args:
        args["multi_t"] = tuple(tuple(t) for t in args["multi_t"])
    if "c_multiplier" in args and not isinstance(args["c_multiplier"],
                                                 (list, tuple)):
        args["c_multiplier"] = (args["c_multiplier"],) * 4
    return args


def sgn_transformer_args(model_args: Dict[str, Any]) -> Dict[str, Any]:
    """A recipe's sgn_transformer `model_args` in the model's names
    (agcn_tpu/models/registry.py:125-159): `bias` -> `use_bias`,
    `*_mha_kwargs` -> `spatial_mha` / `temporal_mha`; `norm_type` must be
    'bn' and `act_type` 'relu' (the only shipped values),
    `semantic_frame_fusion` (unused upstream, sgn_v15.py:130) is dropped,
    and so is `dropout2d`, which reaches only the bert-style (>= 100)
    embedding modes upstream: with one of those it raises."""
    args = dict(model_args)
    if "bias" in args:
        args["use_bias"] = bool(args.pop("bias"))
    for k in ("spatial_mha_kwargs", "temporal_mha_kwargs"):
        if k in args:
            args[k.replace("_kwargs", "")] = args.pop(k)
    for k, allowed in (("norm_type", ("bn",)), ("act_type", ("relu",)),
                       ("semantic_frame_fusion", None)):
        if k in args:
            val = args.pop(k)
            if allowed is not None and val not in allowed:
                raise ValueError(
                    f"sgn_transformer: {k}={val!r} is not supported (only "
                    f"{allowed}, as in the JAX package)")
    if args.pop("dropout2d", 0.0) and any(
            int(args.get(k, 0) or 0) >= 100
            for k in ("input_position", "input_velocity", "semantic_joint",
                      "semantic_frame", "semantic_class")):
        raise ValueError(
            "sgn_transformer: dropout2d with a bert-style (>=100) embedding "
            "mode is not supported, as in the JAX package")
    return args


def import_class(name: str):
    """Dotted-path class loader (reference utils/utils.py:79-84): the
    plug-in mechanism for user-defined models."""
    import importlib

    module, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def build_model(name: str, model_args: Dict[str, Any],
                device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                num_frame: Optional[int] = None,
                edge_mesh: Any = None) -> nn.Module:
    """Build a model from a recipe's `model` and `model_args`, on `device`
    (`cuda` unless named), computing in `dtype`, initialized from
    `generator`. `num_frame`, the input's frames, sizes the tables of a
    model whose class sets `takes_num_frame` (the AAGCN transformer's
    positions, the spatial tokens of the AAGCN versions) and SGN's one-hot
    frames (the loader's `seg`, also the original SGN's and SGN's
    transformer's); the others take any T. `edge_mesh` partitions the
    GCN aggregation of AGCN and AAGCN over its 'edge' axis. A plug-in
    (a dotted path outside `model.`) is built with `cls(**model_args)`
    and moved to `device`."""
    key = model_key(name)
    if edge_mesh is not None and (key.startswith("sgn") or "." in key):
        # fail loudly instead of silently replicating compute over the
        # edge axis (agcn_tpu/models/registry.py:98-106)
        raise ValueError(
            f"mesh_edge > 1 requires a model with in-model edge "
            f"partitioning (agcn/aagcn families); got {name!r}")
    cls = _CLASSES.get(key)
    if cls is None:
        item = waiting_item(name)
        if item:
            raise NotImplementedError(
                f"model {name!r} is not ported yet: it waits in "
                f"ROADMAP {item}")
        if "." in name and not name.startswith("model."):
            # user plug-in: a dotted path to a torch module class/factory
            return import_class(name)(**model_args).to(
                resolve_device(device))
        raise unknown_model(name)
    if cls is SGN:
        args = sgn_args(model_args)
        if num_frame is not None:
            args["num_segment"] = num_frame
        return SGN(device=device, dtype=dtype, generator=generator, **args)
    if cls is SGNTransformer:
        args = sgn_transformer_args(model_args)
        if num_frame is not None:
            args["num_segment"] = num_frame
        return SGNTransformer(device=device, dtype=dtype,
                              generator=generator, **args)
    if cls is SGNOriginal:
        args = dict(model_args)
        if "bias" in args:
            args["use_bias"] = bool(args.pop("bias"))
        if num_frame is not None:
            args["num_frame"] = num_frame
        return SGNOriginal(device=device, dtype=dtype, generator=generator,
                           **args)
    args = dict(model_args)
    graph = args.pop("graph", "ntu_rgb_d")
    graph_args = args.pop("graph_args", {})
    adj = build_adjacency(graph, **graph_args)
    # reference arg names that the models fix: K = 3 subsets, and the
    # original AGCN Model takes no drop_out (reference agcn.py:133)
    args.pop("num_subset", None)
    if cls is AGCN:
        args.pop("drop_out", None)
    if key == "aagcn_v32":
        args["version"] = "v32"
    if getattr(cls, "takes_num_frame", False) and num_frame is not None:
        args["num_frame"] = num_frame
    if edge_mesh is not None:
        if cls not in (AGCN, AAGCN):
            raise ValueError(
                f"mesh_edge > 1 requires a model with in-model edge "
                f"partitioning (agcn/aagcn); got {cls.__name__}")
        args["edge_mesh"] = edge_mesh
    return cls(adj=adj, device=device, dtype=dtype, generator=generator,
               **args)
