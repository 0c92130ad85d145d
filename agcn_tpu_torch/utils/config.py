"""Config / flag system (copy of agcn_tpu/utils/config.py), so the port
loads the same YAML/JSON recipes and takes the same command-line flags: a
flat namespace with nested dicts for model/feeder/dataloader args,
priority CLI > config > defaults, unknown config keys are hard errors."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional

import yaml


@dataclasses.dataclass
class Config:
    # general
    config: Optional[str] = None
    work_dir: str = "./work_dir/temp"
    model_saved_name: str = ""
    assume_yes: bool = False
    auto_resume: bool = False
    async_checkpoint: bool = False
    seed: int = 1337
    profiler: bool = False
    # distributed
    world_size: int = 1
    ddp: bool = False
    # data
    feeder: str = "dense"
    num_worker: int = 4
    train_feeder_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    test_feeder_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train_dataloader_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    test_dataloader_args: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    use_sgn_dataloader: bool = False
    # model
    model: str = "agcn"
    model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    weights: Optional[str] = None
    ignore_weights: List[str] = dataclasses.field(default_factory=list)
    # losses
    label_smoothing: float = 0.0
    loss: str = "ce"
    fl_alpha: List[float] = dataclasses.field(default_factory=list)
    fl_gamma: float = 2.0
    mmd_lambda1: float = 0.0
    mmd_lambda2: float = 0.0
    fsim_mode: int = 0
    fsim_alpha: float = 0.0
    # optimization
    start_epoch: int = 0
    num_epoch: int = 80
    base_lr: float = 0.01
    step: List[int] = dataclasses.field(default_factory=lambda: [20, 40, 60])
    optimizer: str = "SGD"
    nesterov: bool = True
    weight_decay: float = 1e-4
    llrd_factor: float = 1.0
    eps: float = 1e-8
    sam_rho: float = 0.0
    only_train_part: bool = False
    only_train_epoch: int = 0
    warm_up_epoch: int = 0
    scheduler: str = "none"
    anneal_strategy: str = "cos"
    initial_lr: float = 0.0
    final_lr: float = 0.0
    grad_clip: float = 1.0
    # run
    batch_size: int = 64
    test_batch_size: int = 64
    device: Any = 0
    phase: str = "train"
    save_score: bool = False
    log_interval: int = 100
    save_interval: int = 2
    eval_interval: int = 5
    print_log: bool = True
    show_topk: List[int] = dataclasses.field(default_factory=lambda: [1, 5])
    # compute / mesh settings of the recipes
    compute_dtype: str = "float32"
    mesh_data: int = 0
    mesh_edge: int = 1
    steps_per_call: int = 1

    def validate_keys(self, keys):
        known = {f.name for f in dataclasses.fields(self)}
        unknown = [k for k in keys if k not in known]
        if unknown:
            raise KeyError(f"Unknown config keys: {unknown}; "
                           f"known keys: {sorted(known)}")


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a YAML/JSON recipe and apply overrides (CLI > config >
    default)."""
    cfg_dict: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            if path.endswith(".json"):
                nested = json.load(f)
                # nested JSON: flatten one level of sections
                for section in nested.values():
                    if isinstance(section, dict):
                        cfg_dict.update(section)
                    else:
                        raise ValueError("nested JSON config expected")
            else:
                cfg_dict = yaml.safe_load(f) or {}
    cfg = Config()
    cfg.validate_keys(cfg_dict.keys())
    for k, v in cfg_dict.items():
        setattr(cfg, k, v)
    if overrides:
        cfg.validate_keys(overrides.keys())
        for k, v in overrides.items():
            setattr(cfg, k, v)
    if path:
        cfg.config = path
    return cfg


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="agcn_tpu_torch: skeleton action recognition on "
                    "PyTorch + CUDA")
    p.add_argument("--config", type=str, default=None)
    for f in dataclasses.fields(Config):
        if f.name == "config":
            continue
        flag = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            p.add_argument(flag, type=lambda s: s.lower() in
                           ("1", "true", "yes"), default=None)
        elif f.default_factory is not dataclasses.MISSING \
                or f.type.startswith("Dict") or f.type.startswith("List") \
                or f.type.startswith("Any"):
            # Any-typed flags (e.g. --device 0 | cpu | cuda) parse as YAML
            # in config_from_cli; typing them from the default would
            # reject the string forms
            p.add_argument(flag, type=str, default=None)
        else:
            p.add_argument(flag, type=type(f.default)
                           if f.default is not None else str, default=None)
    return p


def config_from_cli(argv=None) -> Config:
    args = build_argparser().parse_args(argv)
    overrides = {}
    for k, v in vars(args).items():
        if k == "config" or v is None:
            continue
        field = next(f for f in dataclasses.fields(Config) if f.name == k)
        if isinstance(v, str) and (field.type.startswith("Dict")
                                   or field.type.startswith("List")
                                   or field.type.startswith("Any")):
            v = yaml.safe_load(v)
        overrides[k] = v
    return load_config(args.config, overrides)


def save_config(cfg: Config, path: str):
    """Snapshot the full arg dict (reference processor.py:79-94)."""
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
