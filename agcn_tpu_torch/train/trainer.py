"""Trainer — the dense AGCN / AAGCN path of agcn_tpu/train/trainer.py's
`Trainer`
(`__init__` :50-92, `_load_data` :128-168, `_load_model` :170-197,
`_load_optimizer` :271-314, `_build_steps` :464-533, `start` :537-559,
`train_epoch` :561-632, `evaluate` :711-821, `save_checkpoint` :823-856;
reference utils/processor.py).

Work-dir management (the reuse guard, config snapshot, `log.txt`,
`metrics.jsonl`, score pickles, right/wrong lists), the epoch loop with
the warmup + step LR, periodic eval with top-k, checkpoints, and the PA
freeze (`only_train_part`). The run lives on one device: `cuda` unless
the config says `device: cpu` (an integer picks that CUDA card).

Not here yet, each refused with its ROADMAP item: the TensorBoard event
files (log.txt and metrics.jsonl carry the same scalars), auto-resume,
async checkpoints, the profiler window, steps_per_call, multi-device and
multi-host runs, the SGN families, the other AAGCN models.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict

import numpy as np
import torch

from agcn_tpu_torch.data.feeder import SkeletonDataset
from agcn_tpu_torch.data.pipeline import BatchIterator
from agcn_tpu_torch.models.registry import build_model
from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
from agcn_tpu_torch.train import checkpoint as ckpt
from agcn_tpu_torch.train import losses as L
from agcn_tpu_torch.train import optim as O
from agcn_tpu_torch.train.steps import (freeze_pa, make_eval_step,
                                        make_train_step)
from agcn_tpu_torch.utils.config import Config, save_config
from agcn_tpu_torch.utils.device import resolve_device

_LEFTOVER = "ROADMAP Queue 1: training leftovers"


def device_from_config(value: Any) -> torch.device:
    """`device` of a recipe: 'cpu', 'cuda', 'cuda:N', or an int N (the
    reference's GPU index) for cuda:N."""
    if isinstance(value, int) and not isinstance(value, bool):
        return resolve_device(f"cuda:{value}")
    if isinstance(value, (list, tuple)):
        raise NotImplementedError(
            f"device {value!r}: multi-device runs wait for ROADMAP Queue 1: "
            "Parallel")
    return resolve_device(str(value))


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the port's CUDA kernels in this process."""
    return {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
            "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches,
            "gcn_bwd": gcn_fused.gcn_backward.launches}


def _refuse_unported(cfg: Config) -> None:
    refused = {
        "auto_resume": (cfg.auto_resume, _LEFTOVER),
        "async_checkpoint": (cfg.async_checkpoint, _LEFTOVER),
        "profiler": (cfg.profiler, _LEFTOVER),
        "steps_per_call > 1": (int(cfg.steps_per_call or 1) > 1, _LEFTOVER),
        "llrd_factor != 1": (cfg.llrd_factor != 1.0, _LEFTOVER),
        "world_size > 1 / ddp": (cfg.world_size > 1 or cfg.ddp,
                                 "ROADMAP Queue 1: Parallel"),
        "mesh_data > 1 / mesh_edge > 1": (
            cfg.mesh_data > 1 or cfg.mesh_edge > 1,
            "ROADMAP Queue 1: Parallel"),
        "SGN (feeder sgn, use_sgn_dataloader, an SGN model)": (
            cfg.use_sgn_dataloader or cfg.feeder == "sgn"
            or "sgn" in cfg.model.lower(),
            "ROADMAP Queue 1: SGN family"),
        "auxiliary losses (mmd_lambda*, fsim_mode)": (
            cfg.mmd_lambda1 > 0 or cfg.mmd_lambda2 > 0 or cfg.fsim_mode > 0,
            "ROADMAP Queue 1: SGN family"),
    }
    for knob, (on, item) in refused.items():
        if on:
            raise NotImplementedError(
                f"{knob}: not in the port yet; waits in {item}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         "bfloat16")


class Trainer:
    def __init__(self, cfg: Config):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.work_dir = cfg.work_dir
        self.device = device_from_config(cfg.device)
        self._guard_work_dir()
        os.makedirs(os.path.join(self.work_dir, "checkpoints"),
                    exist_ok=True)
        os.makedirs(os.path.join(self.work_dir, "score"), exist_ok=True)
        save_config(cfg, os.path.join(self.work_dir, "config.yaml"))
        self._log_file = os.path.join(self.work_dir, "log.txt")
        self._metrics_file = os.path.join(self.work_dir, "metrics.jsonl")

        np.random.seed(cfg.seed)
        torch.manual_seed(cfg.seed)

        self._load_data()
        self._load_model()
        self._load_optimizer()
        self._build_steps()
        self.best_acc = 0.0
        self.best_epoch = -1

    def _guard_work_dir(self):
        """Refuse to clobber a previous run's work dir unless resuming or
        explicitly allowed (reference processor.py:86,100-107)."""
        cfg = self.cfg
        marker = os.path.join(self.work_dir, "log.txt")
        if (cfg.phase == "train" and os.path.exists(marker)
                and cfg.start_epoch == 0 and not cfg.weights
                and not cfg.assume_yes):
            raise RuntimeError(
                f"work_dir {self.work_dir!r} already contains a run "
                f"(log.txt present). Pass assume_yes=true to reuse it, "
                f"or resume with start_epoch/weights, or pick a new dir.")

    # -- logging -------------------------------------------------------

    def print_log(self, msg: str):
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        if self.cfg.print_log:
            print(line, flush=True)
        with open(self._log_file, "a") as f:
            f.write(line + "\n")

    def log_metrics(self, **kv):
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(kv) + "\n")

    # -- construction --------------------------------------------------

    def _load_data(self):
        cfg = self.cfg
        self.loaders: Dict[str, BatchIterator] = {}
        self.datasets: Dict[str, SkeletonDataset] = {}
        if cfg.phase == "train" and cfg.train_feeder_args:
            ds = SkeletonDataset(**cfg.train_feeder_args)
            self.datasets["train"] = ds
            self.loaders["train"] = BatchIterator(
                ds, cfg.batch_size, shuffle=True, drop_last=True,
                seed=cfg.seed, num_workers=cfg.num_worker)
        if cfg.test_feeder_args:
            ds = SkeletonDataset(**cfg.test_feeder_args)
            self.datasets["val"] = ds
            self.loaders["val"] = BatchIterator(
                ds, cfg.test_batch_size, shuffle=False, drop_last=False,
                seed=cfg.seed)

    def _load_model(self):
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.model = build_model(
            cfg.model, cfg.model_args, device=self.device, dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.print_log(f"Model {cfg.model} built: {n_params:,} params")
        self._snapshot_model_source()
        self._ckpt = None
        if cfg.weights:
            self._ckpt = ckpt.load_checkpoint(cfg.weights, cfg.model,
                                              cfg.model_args)
            ckpt.load_model_weights(self.model, self._ckpt["model"],
                                    cfg.ignore_weights, log=self.print_log)
            self.print_log(f"Loaded weights from {cfg.weights}")

    def _snapshot_model_source(self):
        """Copy the model's source file into the work dir for per-run code
        provenance (reference processor.py:288-290)."""
        import inspect

        src = inspect.getsourcefile(type(self.model))
        if src and os.path.exists(src):
            shutil.copy2(src, os.path.join(self.work_dir,
                                           os.path.basename(src)))

    def _load_optimizer(self):
        cfg = self.cfg
        from_ckpt = (self._ckpt or {}).get("steps_per_epoch", 0)
        if "train" in self.loaders:
            steps_per_epoch = max(len(self.loaders["train"]), 1)
        elif from_ckpt > 0:
            # test phase: the checkpoint records the train-set schedule
            # geometry it was produced under
            steps_per_epoch = from_ckpt
        elif "val" in self.loaders:
            steps_per_epoch = max(
                len(self.datasets["val"]) // max(cfg.batch_size, 1), 1)
        else:
            steps_per_epoch = 1
        self.steps_per_epoch = steps_per_epoch
        self.schedule = O.build_schedule(cfg.scheduler, cfg.base_lr,
                                         steps_per_epoch, cfg.step,
                                         cfg.warm_up_epoch)
        self.optimizer = O.build_optimizer(
            cfg.optimizer, self.model.parameters(), self.schedule,
            cfg.weight_decay, cfg.nesterov, grad_clip=cfg.grad_clip)
        if self._ckpt is not None and "optimizer" in self._ckpt:
            # exact resume: momentum buffers and the update count
            self.optimizer.load_state_dict(self._ckpt["optimizer"])
            self.print_log(f"optimizer state resumed at step "
                           f"{self.optimizer.count}")

    def _build_steps(self):
        cfg = self.cfg
        loss_fn = L.build_loss(cfg.loss, cfg.model_args.get("num_class", 60),
                               smoothing=cfg.label_smoothing,
                               alpha=cfg.fl_alpha, gamma=cfg.fl_gamma)
        sam_rho = cfg.sam_rho if cfg.optimizer.upper().startswith("SAM") \
            else 0.0
        self._train_step = make_train_step(self.model, loss_fn,
                                           self.optimizer, sam_rho=sam_rho)
        # PA frozen while epoch <= only_train_epoch
        # (reference processor.py:612-630)
        self._train_step_frozen = make_train_step(
            self.model, loss_fn, self.optimizer, grad_transform=freeze_pa) \
            if cfg.only_train_part else self._train_step
        self._eval_step = make_eval_step(self.model, loss_fn)

    # -- phases --------------------------------------------------------

    def start(self):
        cfg = self.cfg
        if cfg.phase == "train":
            for epoch in range(cfg.start_epoch, cfg.num_epoch):
                self.train_epoch(epoch)
                if (epoch + 1) % cfg.eval_interval == 0 \
                        or epoch + 1 == cfg.num_epoch:
                    self.evaluate(epoch, save_score=cfg.save_score)
                if (epoch + 1) % cfg.save_interval == 0 \
                        or epoch + 1 == cfg.num_epoch:
                    self.save_checkpoint(epoch)
            self.print_log(
                f"Best top-1: {self.best_acc:.4f} @ epoch {self.best_epoch}")
        elif cfg.phase == "test":
            if not cfg.weights:
                raise ValueError("--weights required for phase test")
            self.evaluate(0, save_score=cfg.save_score,
                          write_predictions=True)
        else:
            raise ValueError(f"Unknown phase {cfg.phase}")

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        loader = self.loaders["train"]
        loader.set_epoch(epoch)
        t0 = time.time()
        launches0 = kernel_launches()
        seen = 0
        last = {}
        step_fn = (self._train_step_frozen
                   if cfg.only_train_part and epoch <= cfg.only_train_epoch
                   else self._train_step)
        for i, (x, y, _) in enumerate(loader):
            metrics = step_fn(self._to_device(x), self._to_device(y))
            seen += len(y)
            if (i + 1) % cfg.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.print_log(
                    f"epoch {epoch} step {i + 1}/{len(loader)} "
                    f"loss {m['loss']:.4f} acc {m['acc']:.3f} "
                    f"lr {self.optimizer.lr():.5f}")
            last = metrics
        m = {k: float(v) for k, v in last.items()}  # waits for the device
        dt = time.time() - t0
        launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
        self.log_metrics(kind="train", epoch=epoch, seconds=dt,
                         seq_per_sec=seen / max(dt, 1e-9),
                         steps=self.optimizer.count, launches=launches, **m)
        self.print_log(
            f"epoch {epoch} done in {dt:.1f}s "
            f"({seen / max(dt, 1e-9):.1f} seq/s)")

    def evaluate(self, epoch: int, save_score: bool = False,
                 write_predictions: bool = False):
        cfg = self.cfg
        if "val" not in self.loaders:
            return None
        ds = self.datasets["val"]
        t0 = time.time()
        scores = []
        for x, _, _ in self.loaders["val"]:
            logits, _ = self._eval_step(self._to_device(x))
            scores.append(logits.float().cpu().numpy())
        score = np.concatenate(scores, axis=0)[: len(ds)]
        accs = {k: ds.top_k(score, k) for k in cfg.show_topk}
        dt = time.time() - t0
        if accs.get(1, 0.0) > self.best_acc:
            self.best_acc = accs.get(1, 0.0)
            self.best_epoch = epoch
        msg = ", ".join(f"top-{k}: {v:.4f}" for k, v in accs.items())
        self.print_log(f"eval epoch {epoch}: {msg} ({dt:.1f}s)")
        self.log_metrics(kind="eval", epoch=epoch, seconds=dt,
                         **{f"top{k}": v for k, v in accs.items()})
        if save_score:
            names = getattr(ds, "sample_name", np.arange(len(ds)))
            out = {str(n): s for n, s in zip(names, score)}
            path = os.path.join(self.work_dir, "score",
                                f"epoch{epoch + 1}_val.pkl")
            with open(path, "wb") as f:
                pickle.dump(out, f)
        if write_predictions:
            pred = score.argmax(-1)
            with open(os.path.join(self.work_dir, "right.txt"), "w") as fr, \
                    open(os.path.join(self.work_dir, "wrong.txt"), "w") as fw:
                for i, (p, l) in enumerate(zip(pred, ds.label)):
                    (fr if p == l else fw).write(f"{i},{p},{l}\n")
        return accs

    def save_checkpoint(self, epoch: int):
        # filename prefix from model_saved_name (reference names weights
        # {model_saved_name}-{epoch}-{global_step}.pt, processor.py:225-231)
        prefix = os.path.basename(self.cfg.model_saved_name or "epoch") \
            or "epoch"
        path = ckpt.save_checkpoint(
            os.path.join(self.work_dir, "checkpoints",
                         f"{prefix}_{epoch + 1}"),
            self.model, self.optimizer.state_dict(),
            step=self.optimizer.count, epoch=epoch,
            steps_per_epoch=self.steps_per_epoch)
        self.print_log(f"checkpoint saved: {path}")
