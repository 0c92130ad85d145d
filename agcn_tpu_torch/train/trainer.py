"""Trainer — the AGCN / AAGCN / AAGCN-transformer / AAGCN-version / SGN
(the original SGN and SGN's transformer too) paths of
agcn_tpu/train/trainer.py's `Trainer` (`__init__` :50-92, `_load_data`
:128-168, `_load_model` :170-197, `_load_optimizer` :271-353,
`_build_aux_loss` :381-462, `_build_steps` :464-533, `start` :537-559,
`train_epoch` :561-709, `evaluate` :711-821, `save_checkpoint` :823-856;
reference utils/processor.py).

Work-dir management (the reuse guard, config snapshot, `log.txt`,
`metrics.jsonl`, score pickles, right/wrong lists), the epoch loop with
the recipe's optimizer (SGD nesterov, Adam, AdamW, each with LLRD when
its name says so) and schedule (warmup + step, onecycle, cyclic),
periodic eval with top-k, checkpoints that resume the optimizer state
exactly, and the PA freeze (`only_train_part`). A run without a
launcher lives on one device: `cuda` unless the config says `device:
cpu` (an integer picks that CUDA card). The model is built after the
data, for the data's frames (the AAGCN transformer's position tables,
the spatial tokens of AAGCN v31 / v34, SGN's one-hot frame table: the
loader's `seg`).

The SGN recipes (`feeder: sgn`, `use_sgn_dataloader`, an SGN model;
JAX `is_sgn`, trainer.py:85-86) load `SGNDataset` and collate segments
with `SegmentSampler` (train: one crop and the batch rotation; eval:
`multi_test` consecutive crops a sample, whose logits the eval step
averages). SGN computes in fp32: `compute_dtype: bfloat16` logs the JAX
trainer's line and runs fp32.

The run knobs, as the JAX trainer's:

- TensorBoard event files (`utils/tb_writer.py`) in phase train:
  `work_dir/event/train` takes `train/loss`, `train/acc` and `train/lr`
  at each logged step and `train/epoch` at each epoch's end, keyed by the
  optimizer's count; `work_dir/event/val` takes `val/top{k}` after each
  eval. The scalars are those of log.txt and metrics.jsonl.
- `auto_resume`: a run in a work dir that holds checkpoints continues
  from the newest `<prefix>_<N>.pt` (model, optimizer state and count,
  the next epoch); one that fails to load is logged and skipped.
- `async_checkpoint`: saves write in a background thread from a host
  snapshot taken before the next step (`train/checkpoint.py`); `start`
  waits for them, and a failed write raises.
- `profiler`: steps 2-7 of the run's first epoch traced by
  `torch.profiler` (CPU and CUDA activity on a GPU) into a Chrome trace
  in `work_dir/trace/`; on a GPU a trace without CUDA events raises.
- `optimizer: SAM*` with `sam_rho`: SGD nesterov under SAM's two-pass
  step (`train/steps.py`).
- `steps_per_call` K > 1: K loader batches stacked on the host, one copy
  to the device, K steps back to back in the one epoch loop; the metrics
  come to the host only at logged steps and at the epoch's end (the last
  group may hold fewer batches; the profiled epoch takes K = 1). The
  updates are those of K = 1.
- `fsim_mode` > 0: the cosine feature-similarity loss of the SGN
  temporal branches (`fsim` in metrics.jsonl and the eval log).
- `mmd_lambda1` / `mmd_lambda2` > 0: the InfoGCN MMD loss on the latent
  z of an SGN with the InfoGCN head (`infogcn_*`), against the head's
  `z_prior` (`mmd`, `l2_z_mean`, `cos_z`, `dist_z`, `cos_z_prior` and
  `dist_z_prior` in metrics.jsonl and the eval log). Without the head the
  JAX trainer draws a fallback prior with jax.random, which the port
  cannot reproduce: it raises (ROADMAP Queue 3, a known difference).

Every model of the JAX registry trains here (SGN's transformer, v15,
since Queue 1 item 7.3: its tuple output (logits, attention) reaches the
steps, which take the logits).

Data-parallel and edge-partitioned runs (agcn_tpu trainer.py:79-83,
132-133, 496-502, 736-784, 840-856): under a launcher
(`parallel.init_distributed`, called by `agcn_tpu_torch.main`) each rank
runs this trainer on its card, on a (data, edge) mesh of the recipe's
`mesh_data` x `mesh_edge` (`mesh_data` 0: the world over `mesh_edge`).

- Data: each data rank loads its shard of the train and val sets
  (`batch_size` per data rank: the global batch is batch_size x data).
  The model is wrapped in DistributedDataParallel over the data axis
  (also at data 1, where its all-reduce is the identity), every
  BatchNorm takes the statistics of all data ranks' rows (SyncBN, as
  GSPMD computes them over the global batch; a Ghost BN keeps its
  per-rank splits, as the JAX module does), the clip sees the reduced
  gradient, the logged loss and accuracy are the data ranks' mean, and
  dropout folds the data rank into its masks' seed. `steps_per_call`
  falls back to 1 at data > 1, as in JAX.
- Edge: at `mesh_edge` > 1 the model (AGCN or AAGCN) partitions its
  GCN aggregation over the edge axis (parallel/edge_partition.py); the
  edge ranks of a data rank load the same rows.
- Eval: each data rank scores its shard; the rows are all-gathered over
  the data axis, interleaved back into the loader's order and cut to the
  set's size. The aux eval metrics are skipped at world > 1.
- Rank 0 alone writes log.txt, metrics.jsonl, the event files, the
  config and model-source snapshots, the profiler trace, checkpoints
  (the module's own names, synchronous at world > 1) and scores.
- `ddp` is read nowhere, as in JAX; a `world_size` above 1 must equal
  the launcher's, and without a launcher it raises
  (parallel/mesh.check_world).

The JAX package's auxiliary losses (SGN's MMD, fsim) see the global
batch; here each data rank's rows, as the reference's DDP does.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from agcn_tpu_torch.data.feeder import SGNDataset, SkeletonDataset
from agcn_tpu_torch.data.pipeline import BatchIterator, make_sgn_collate
from agcn_tpu_torch.data.sgn_collate import SegmentSampler
from agcn_tpu_torch.models.registry import build_model
from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
from agcn_tpu_torch.ops.norm import sync_batch_norms
from agcn_tpu_torch.parallel import mesh as M
from agcn_tpu_torch.train import checkpoint as ckpt
from agcn_tpu_torch.train import losses as L
from agcn_tpu_torch.train import optim as O
from agcn_tpu_torch.train.steps import (freeze_pa, make_eval_step,
                                        make_train_step)
from agcn_tpu_torch.utils.config import Config, save_config
from agcn_tpu_torch.utils.device import resolve_device
from agcn_tpu_torch.utils.tb_writer import SummaryWriter

# the profiler's window in the run's first epoch (agcn_tpu trainer.py:572;
# reference torch.profiler schedule wait=1 warmup=1 active=5)
PROFILE_STEPS = range(2, 8)


def device_from_config(value: Any) -> torch.device:
    """`device` of a recipe: 'cpu', 'cuda', 'cuda:N', or an int N (the
    reference's GPU index) for cuda:N; a list of one card is that card
    (a longer list needs a launcher: parallel/mesh.check_world)."""
    if isinstance(value, (list, tuple)) and len(value) == 1:
        value = value[0]
    if isinstance(value, int) and not isinstance(value, bool):
        return resolve_device(f"cuda:{value}")
    return resolve_device(str(value))


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the port's CUDA kernels in this process."""
    return {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
            "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches,
            "gcn_bwd": gcn_fused.gcn_backward.launches}


def _check_config(cfg: Config) -> None:
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         "bfloat16")


def _mean_all_reduce(group, bucket):
    """DDP comm hook: the bucket's mean over the group, one AVG
    all-reduce."""
    work = torch.distributed.all_reduce(
        bucket.buffer(), op=torch.distributed.ReduceOp.AVG, group=group,
        async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def _groups(batches, k: int):
    """Lists of k consecutive items of `batches`; the last may hold
    fewer."""
    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def build_aux_loss(cfg: Config, model: torch.nn.Module
                   ) -> Optional[Callable]:
    """The auxiliary losses of a recipe (agcn_tpu trainer.py:381-462;
    reference processor.py:563-595), as (aux, y) -> (loss, metrics) over
    the model's aux outputs, or None:

    - the InfoGCN MMD loss, mmd_lambda2 * mmd + mmd_lambda1 * l2_z_mean,
      of the aux latent `z` against the head's `z_prior` (tiled when its
      width differs from z's), with its six metrics;
    - the cosine feature-similarity loss between the temporal branches'
      outputs (`fsim_mode`): pairs over len(multi_t[-1]) kernels a level,
      weighted by `fsim_alpha`; its `fsim` metric.

    Aux outputs without `z` (or branches) add nothing, as in JAX. The MMD
    loss of a model without the InfoGCN head raises: JAX's fallback prior
    is a jax.random draw the port cannot reproduce."""
    use_mmd = cfg.mmd_lambda1 > 0 or cfg.mmd_lambda2 > 0
    use_fsim = cfg.fsim_mode > 0
    if not (use_mmd or use_fsim):
        return None
    if use_mmd and getattr(model, "z_prior", None) is None:
        raise NotImplementedError(
            "the MMD loss (mmd_lambda1 / mmd_lambda2) needs the InfoGCN head "
            "(infogcn_noise_ratio and infogcn_gain), whose z_prior is its "
            "prior: without it the JAX trainer draws a fallback prior with "
            "jax.random, which the port cannot reproduce (ROADMAP Queue 3, "
            "a known difference)")
    num_class = cfg.model_args.get("num_class", 60)
    alphas = (list(cfg.fsim_alpha)
              if isinstance(cfg.fsim_alpha, (list, tuple))
              else [cfg.fsim_alpha])
    multi_t = cfg.model_args.get("multi_t", [[], [], [3]])
    kernels = len(multi_t[-1]) if multi_t else 1

    def aux_loss(aux, y):
        aux = aux or {}
        total, metrics = 0.0, {}
        if use_mmd and "z" in aux:
            z, prior = aux["z"], aux["z_prior"]
            if prior.shape[-1] != z.shape[-1]:
                reps = -(-z.shape[-1] // prior.shape[-1])
                prior = prior.repeat(1, reps)[:, :z.shape[-1]]
            mmd, l2z = L.mmd_loss(z, prior, y, num_class)
            total = total + cfg.mmd_lambda2 * mmd + cfg.mmd_lambda1 * l2z
            metrics.update(mmd=mmd, l2_z_mean=l2z, **L.latent_diagnostics(
                z, prior, y, num_class))
        outs = aux.get("branch_outputs", [])
        if use_fsim and len(outs) > 1:
            fsim = L.fsim_pair_loss(outs, alphas, kernels,
                                    mode=cfg.fsim_mode)
            total = total + fsim
            metrics["fsim"] = fsim
        return total, metrics

    return aux_loss


class Trainer:
    def __init__(self, cfg: Config):
        _check_config(cfg)
        self.cfg = cfg
        self.work_dir = cfg.work_dir
        self.mesh = self._make_mesh()
        self.data = self.mesh.shape["data"] if self.mesh else 1
        self.data_rank = self.mesh.coordinate("data") if self.mesh else 0
        # rank 0 owns every work-dir artifact (agcn_tpu trainer.py:56)
        self.is_main = M.is_main()
        self.device = (M.rank_device(cfg.device) if self.mesh
                       else device_from_config(cfg.device))
        self.is_sgn = (cfg.use_sgn_dataloader or cfg.feeder == "sgn"
                       or "sgn" in cfg.model.lower())
        self._guard_work_dir()
        if self.mesh:  # no rank writes before every rank looked
            torch.distributed.barrier()
        os.makedirs(os.path.join(self.work_dir, "checkpoints"),
                    exist_ok=True)
        os.makedirs(os.path.join(self.work_dir, "score"), exist_ok=True)
        if self.is_main:
            save_config(cfg, os.path.join(self.work_dir, "config.yaml"))
        self._log_file = os.path.join(self.work_dir, "log.txt")
        self._metrics_file = os.path.join(self.work_dir, "metrics.jsonl")
        if self.mesh:
            self.print_log(
                f"process group: {torch.distributed.get_backend()}, "
                f"{M.world_size()} ranks as {self.mesh}, on {self.device}")
        # TensorBoard event writers (reference processor.py:125-132)
        self.train_writer = self.val_writer = None
        if cfg.phase == "train" and self.is_main:
            self.train_writer = SummaryWriter(
                os.path.join(self.work_dir, "event", "train"))
            self.val_writer = SummaryWriter(
                os.path.join(self.work_dir, "event", "val"))

        np.random.seed(cfg.seed)
        torch.manual_seed(cfg.seed)

        self._load_data()
        self._load_model()
        self._load_optimizer()
        self._build_steps()
        self.best_acc = 0.0
        self.best_epoch = -1

    def _make_mesh(self) -> Optional[M.Mesh]:
        """The (data, edge) mesh of a run in a process group, or None for
        a run without a launcher (which must ask for one rank)."""
        cfg = self.cfg
        world = M.check_world(cfg)
        if M.distributed():
            return M.make_mesh(cfg.mesh_data, cfg.mesh_edge)
        if world > 1:
            raise RuntimeError(
                f"WORLD_SIZE {world} but no process group: call "
                "agcn_tpu_torch.parallel.init_distributed first "
                "(agcn_tpu_torch.main does)")
        M.mesh_shape(cfg.mesh_data, cfg.mesh_edge, 1)
        return None

    def _guard_work_dir(self):
        """Refuse to clobber a previous run's work dir unless resuming or
        explicitly allowed (reference processor.py:86,100-107)."""
        cfg = self.cfg
        marker = os.path.join(self.work_dir, "log.txt")
        if (cfg.phase == "train" and os.path.exists(marker)
                and cfg.start_epoch == 0 and not cfg.weights
                and not cfg.assume_yes and not cfg.auto_resume):
            raise RuntimeError(
                f"work_dir {self.work_dir!r} already contains a run "
                f"(log.txt present). Pass assume_yes=true to reuse it, "
                f"or resume with start_epoch/weights, or pick a new dir.")

    # -- logging -------------------------------------------------------

    def print_log(self, msg: str):
        if not self.is_main:  # rank-0 logging (processor.py:138-146)
            return
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        if self.cfg.print_log:
            print(line, flush=True)
        with open(self._log_file, "a") as f:
            f.write(line + "\n")

    def log_metrics(self, **kv):
        if not self.is_main:
            return
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(kv) + "\n")

    # -- construction --------------------------------------------------

    def _load_data(self):
        """The datasets and loaders (agcn_tpu trainer.py:135-161): dense,
        or SGN with its segment collate; `multi_test` is the eval crops a
        sample."""
        cfg = self.cfg
        self.loaders: Dict[str, BatchIterator] = {}
        self.datasets: Dict[str, Any] = {}
        self.multi_test = 1
        # the data ranks' shards; the edge ranks of one load the same rows
        shards = dict(num_shards=self.data, shard_index=self.data_rank)
        if cfg.phase == "train" and cfg.train_feeder_args:
            collate = None
            if self.is_sgn:
                ds = SGNDataset(**cfg.train_feeder_args)
                sampler = SegmentSampler(
                    dataset=cfg.train_feeder_args.get("dataset", "NTU60-CV"),
                    **cfg.train_dataloader_args)
                collate = make_sgn_collate(sampler, train=True)
            else:
                ds = SkeletonDataset(**cfg.train_feeder_args)
            self.datasets["train"] = ds
            self.loaders["train"] = BatchIterator(
                ds, cfg.batch_size, shuffle=True, drop_last=True,
                seed=cfg.seed, collate=collate, num_workers=cfg.num_worker,
                **shards)
        if cfg.test_feeder_args:
            collate = None
            if self.is_sgn:
                ds = SGNDataset(**cfg.test_feeder_args)
                sampler = SegmentSampler(
                    dataset=cfg.test_feeder_args.get("dataset", "NTU60-CV"),
                    **cfg.test_dataloader_args)
                self.multi_test = sampler.multi_test
                collate = make_sgn_collate(sampler, train=False,
                                           multi_crop=self.multi_test > 1)
            else:
                ds = SkeletonDataset(**cfg.test_feeder_args)
            self.datasets["val"] = ds
            self.loaders["val"] = BatchIterator(
                ds, cfg.test_batch_size, shuffle=False, drop_last=False,
                seed=cfg.seed, collate=collate, **shards)

    def _data_frames(self):
        """The frames T of a sample as the loaders yield it (None without
        data): SGN's segments `seg` (agcn_tpu trainer.py:215-220), else
        the dense samples' T."""
        cfg = self.cfg
        if self.is_sgn:
            return cfg.train_dataloader_args.get(
                "seg", cfg.test_dataloader_args.get("seg", 20))
        ds = self.datasets.get("train") or self.datasets.get("val")
        return None if ds is None or not len(ds) else ds[0][0].shape[1]

    def _load_model(self):
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        if dtype is not None and "sgn" in cfg.model.lower():
            # the JAX trainer's line (agcn_tpu trainer.py:174-183)
            self.print_log("compute_dtype bfloat16 is not supported by the "
                           "SGN families; running float32")
            dtype = None
        edge_mesh = self.mesh if cfg.mesh_edge > 1 else None
        self.model = build_model(
            cfg.model, cfg.model_args, device=self.device, dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed),
            num_frame=self._data_frames(), edge_mesh=edge_mesh)
        if self.mesh:
            # global-batch statistics in every BN; data ranks' own masks
            sync_batch_norms(self.model, "data")
            self.model.dropout_shard = self.data_rank
        n_params = sum(p.numel() for p in self.model.parameters())
        self.print_log(f"Model {cfg.model} built: {n_params:,} params")
        if self.is_main:
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
        self.optimizer = O.from_config(cfg, self.model.named_parameters(),
                                       steps_per_epoch)
        if self._ckpt is not None and "optimizer" in self._ckpt:
            self._resume_optimizer(self._ckpt)
        elif cfg.auto_resume and cfg.phase == "train" and not cfg.weights:
            self._auto_resume()

    def _resume_optimizer(self, state: Dict[str, Any]):
        # exact resume: momentum buffers / Adam moments and the count
        self.optimizer.load_state_dict(state["optimizer"])
        self.print_log(f"optimizer state resumed at step "
                       f"{self.optimizer.count}")

    def _auto_resume(self):
        """Continue from the newest `<prefix>_<N>.pt` in
        work_dir/checkpoints, by N: the model, the optimizer state and
        count, and the epoch after the checkpoint's (agcn_tpu
        trainer.py:316-353). A checkpoint that fails to load is logged and
        skipped; none means a fresh start."""
        cfg = self.cfg
        ckpt_dir = os.path.join(self.work_dir, "checkpoints")
        cands = []
        for name in os.listdir(ckpt_dir):
            stem, ext = os.path.splitext(name)
            tail = stem.rsplit("_", 1)[-1]
            if ext == ".pt" and "_" in stem and tail.isdigit():
                cands.append((int(tail), os.path.join(ckpt_dir, name)))
        if not cands:
            return
        number, path = max(cands)
        try:
            state = ckpt.load_checkpoint(path, cfg.model, cfg.model_args)
            odd = set(state["model"]) ^ set(self.model.state_dict())
            if odd or "optimizer" not in state:
                raise ValueError(f"not a checkpoint of this run's model and "
                                 f"optimizer (names apart: {sorted(odd)})")
            self.model.load_state_dict(state["model"], strict=True)
            self._resume_optimizer(state)
        except Exception as e:
            self.print_log(f"auto-resume skipped ({e})")
            return
        cfg.start_epoch = int(state.get("epoch", number - 1)) + 1
        self.print_log(f"auto-resumed from {path} "
                       f"(continuing at epoch {cfg.start_epoch})")

    def _build_steps(self):
        cfg = self.cfg
        loss_fn = L.build_loss(cfg.loss, cfg.model_args.get("num_class", 60),
                               smoothing=cfg.label_smoothing,
                               alpha=cfg.fl_alpha, gamma=cfg.fl_gamma)
        sam_rho = cfg.sam_rho if cfg.optimizer.upper().startswith("SAM") \
            else 0.0
        aux_loss_fn = build_aux_loss(cfg, self.model)
        ddp = self._wrap_data_parallel()

        def step(**kw):
            return self._mean_over_data(make_train_step(
                self.model, loss_fn, self.optimizer, sam_rho=sam_rho,
                aux_loss_fn=aux_loss_fn, forward=ddp, **kw))

        self._train_step = step()
        # the PA freeze (reference processor.py:612-630): the gradients
        # are zeroed, requires_grad stays (DDP's reducer needs it)
        self._train_step_frozen = step(grad_transform=freeze_pa) \
            if cfg.only_train_part else self._train_step
        self._steps_per_call = max(1, int(cfg.steps_per_call or 1))
        if self._steps_per_call > 1 and self.data > 1:
            self.print_log("steps_per_call > 1 requires a single data "
                           "shard; falling back to 1")
            self._steps_per_call = 1
        self._eval_aux = aux_loss_fn
        self._eval_step = make_eval_step(self.model, loss_fn,
                                         multi_crop=self.multi_test,
                                         aux_loss_fn=aux_loss_fn)

    def _wrap_data_parallel(self):
        """DistributedDataParallel over the data axis in a process group
        (None without one). Buffers are not broadcast: SyncBN keeps every
        rank's running statistics equal. A parameter the forward may leave
        unused (SGN's G `alpha`) needs the unused-parameter search. On
        NCCL each gradient bucket's mean is one AVG all-reduce (DDP's own
        hook divides, then sums; gloo has no AVG)."""
        if not self.mesh:
            return None
        from torch.nn.parallel import DistributedDataParallel

        group = self.mesh.group("data")
        ddp = DistributedDataParallel(
            self.model, process_group=group,
            device_ids=[self.device] if self.device.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=self.is_sgn)
        if torch.distributed.get_backend(group) == "nccl":
            ddp.register_comm_hook(group, _mean_all_reduce)
        return ddp

    def _mean_over_data(self, step: Callable) -> Callable:
        """`step` with its metrics averaged over the data ranks: the
        global batch's loss and accuracy, as the JAX step reports them."""
        if self.data == 1:
            return step
        group = self.mesh.group("data")

        def run(x, y):
            metrics = step(x, y)
            keys = sorted(metrics)
            t = torch.stack([metrics[k].float() for k in keys])
            torch.distributed.all_reduce(t, group=group)
            return dict(zip(keys, (t / self.data).unbind()))

        return run

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
            ckpt.wait_for_checkpoints()
            for writer in (self.train_writer, self.val_writer):
                if writer is not None:
                    writer.close()
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

    def _log_step(self, epoch: int, i: int, n_steps: int,
                  metrics: Dict[str, float], count: int):
        """The log line and the event scalars of logged step i, keyed by
        the optimizer's count after it."""
        lr = self.optimizer.schedule(count)
        self.print_log(
            f"epoch {epoch} step {i}/{n_steps} "
            f"loss {metrics['loss']:.4f} acc {metrics['acc']:.3f} "
            f"lr {lr:.5f}")
        if self.train_writer is not None:
            self.train_writer.add_scalar("train/loss", metrics["loss"],
                                         count)
            self.train_writer.add_scalar("train/acc", metrics["acc"], count)
            self.train_writer.add_scalar("train/lr", lr, count)

    def _step_fn(self, epoch: int):
        """The train step of `epoch`: PA frozen while epoch <=
        only_train_epoch."""
        if self.cfg.only_train_part and epoch <= self.cfg.only_train_epoch:
            return self._train_step_frozen
        return self._train_step

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        loader = self.loaders["train"]
        loader.set_epoch(epoch)
        t0 = time.time()
        launches0 = kernel_launches()
        profiled = cfg.profiler and epoch == cfg.start_epoch and self.is_main
        seen, last = self._train_epoch_steps(epoch, loader, profiled)
        m = {k: float(v) for k, v in last.items()}  # waits for the device
        dt = time.time() - t0
        launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
        self.log_metrics(kind="train", epoch=epoch, seconds=dt,
                         seq_per_sec=seen / max(dt, 1e-9),
                         steps=self.optimizer.count, launches=launches, **m)
        if self.train_writer is not None:
            self.train_writer.add_scalar("train/epoch", epoch,
                                         self.optimizer.count)
            self.train_writer.flush()
        self.print_log(
            f"epoch {epoch} done in {dt:.1f}s "
            f"({seen / max(dt, 1e-9):.1f} seq/s)")

    def _train_epoch_steps(self, epoch: int, loader, profiled: bool):
        """One step a loader batch. The batches go to the device
        K = `steps_per_call` at a time, stacked on the host into one copy,
        and their K steps run back to back (agcn_tpu trainer.py:634-709);
        the metrics come to the host only at logged steps and at the end.
        The last group may hold fewer. With `profiled`, K = 1 and steps
        2-7 are traced."""
        cfg = self.cfg
        step_fn = self._step_fn(epoch)
        spc = 1 if profiled else self._steps_per_call
        n_steps = len(loader)
        prof = None
        seen = done = 0
        last: Dict[str, Any] = {}
        for group in _groups(loader, spc):
            xs = self._to_device(np.stack([x for x, _, _ in group]))
            ys = self._to_device(np.stack([y for _, y, _ in group]))
            seen += ys.numel()
            count0 = self.optimizer.count
            rows = []
            for j in range(len(group)):
                if profiled and done == PROFILE_STEPS.start:
                    prof = self._start_profiler()
                rows.append(step_fn(xs[j], ys[j]))
                done += 1
                if prof is not None and done == PROFILE_STEPS.stop:
                    self._stop_profiler(prof, epoch)
                    prof = None
            for j, metrics in enumerate(rows):
                i = done - len(rows) + j + 1
                if i % cfg.log_interval == 0:
                    self._log_step(epoch, i, n_steps,
                                   {k: float(v) for k, v in metrics.items()},
                                   count0 + j + 1)
            last = rows[-1]
        if prof is not None:  # an epoch shorter than the window
            self._stop_profiler(prof, epoch)
        return seen, last

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, epoch: int):
        """End the window: wait for the device, stop, write the Chrome
        trace into work_dir/trace. On a GPU a trace without CUDA events
        is an error."""
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        trace_dir = os.path.join(self.work_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        # the raw events: `prof.events()` would build the Python event
        # tree of the whole window first (seconds for six steps)
        if self.device.type == "cuda" and not any(
                ev.device_type() == DeviceType.CUDA
                for ev in prof.profiler.kineto_results.events()):
            raise RuntimeError("profiler: the trace of steps "
                               f"{PROFILE_STEPS.start}-"
                               f"{PROFILE_STEPS.stop - 1} holds no CUDA "
                               "event")
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"epoch{epoch}_steps{PROFILE_STEPS.start}-"
                       f"{PROFILE_STEPS.stop - 1}.pt.trace.json"))
        self.print_log(f"profiler trace written to {trace_dir}")

    def evaluate(self, epoch: int, save_score: bool = False,
                 write_predictions: bool = False):
        cfg = self.cfg
        if "val" not in self.loaders:
            return None
        ds = self.datasets["val"]
        t0 = time.time()
        crops = self.multi_test
        full = cfg.test_batch_size * crops
        scores = []
        aux_metrics = []
        # the aux metrics ride full batches of one process
        # (agcn_tpu trainer.py:741-744)
        aux_eval = self._eval_aux is not None and M.world_size() == 1
        for x, y, _ in self.loaders["val"]:
            if x.shape[0] % crops:
                raise RuntimeError(
                    f"eval batch of {x.shape[0]} rows is not a multiple of "
                    f"multi_test={crops}; collate must expand each sample "
                    f"into consecutive crops")
            # one row a sample: the eval step averages its crops' logits
            if aux_eval and x.shape[0] == full:
                # the aux metrics on full batches, z averaged over the
                # crops (agcn_tpu trainer.py:741-749)
                logits, m = self._eval_step(
                    self._to_device(x), self._to_device(y[::crops]))
                aux_metrics.append({k: float(v) for k, v in m.items()})
            else:
                logits, _ = self._eval_step(self._to_device(x))
            scores.append(logits.float().cpu().numpy())
        score = np.concatenate(scores, axis=0)
        if self.mesh:
            # every data rank's shard, back in the loader's padded order
            score = M.gather_rows(score, self.mesh)
        score = score[: len(ds)]
        accs = {k: ds.top_k(score, k) for k in cfg.show_topk}
        dt = time.time() - t0
        if accs.get(1, 0.0) > self.best_acc:
            self.best_acc = accs.get(1, 0.0)
            self.best_epoch = epoch
        msg = ", ".join(f"top-{k}: {v:.4f}" for k, v in accs.items())
        self.print_log(f"eval epoch {epoch}: {msg} ({dt:.1f}s)")
        aux_means = {}
        if aux_metrics:
            aux_means = {k: float(np.mean([m[k] for m in aux_metrics]))
                         for k in aux_metrics[0]}
            self.print_log("eval aux: " + ", ".join(
                f"{k} {v:.4f}" for k, v in aux_means.items()))
        self.log_metrics(kind="eval", epoch=epoch, seconds=dt,
                         **{f"top{k}": v for k, v in accs.items()},
                         **aux_means)
        if self.val_writer is not None:
            for k, v in accs.items():
                self.val_writer.add_scalar(f"val/top{k}", v,
                                           self.optimizer.count)
            self.val_writer.flush()
        if save_score and self.is_main:
            names = getattr(ds, "sample_name", np.arange(len(ds)))
            out = {str(n): s for n, s in zip(names, score)}
            path = os.path.join(self.work_dir, "score",
                                f"epoch{epoch + 1}_val.pkl")
            with open(path, "wb") as f:
                pickle.dump(out, f)
        if write_predictions and self.is_main:
            pred = score.argmax(-1)
            with open(os.path.join(self.work_dir, "right.txt"), "w") as fr, \
                    open(os.path.join(self.work_dir, "wrong.txt"), "w") as fw:
                for i, (p, l) in enumerate(zip(pred, ds.label)):
                    (fr if p == l else fw).write(f"{i},{p},{l}\n")
        return accs

    def save_checkpoint(self, epoch: int):
        if not self.is_main:  # rank-0 saves (processor.py:777)
            return
        # filename prefix from model_saved_name (reference names weights
        # {model_saved_name}-{epoch}-{global_step}.pt, processor.py:225-231)
        prefix = os.path.basename(self.cfg.model_saved_name or "epoch") \
            or "epoch"
        multi = M.world_size() > 1
        # the module's own names (not DDP's `module.` ones)
        path = ckpt.save_checkpoint(
            os.path.join(self.work_dir, "checkpoints",
                         f"{prefix}_{epoch + 1}"),
            self.model, self.optimizer.state_dict(),
            step=self.optimizer.count, epoch=epoch,
            steps_per_epoch=self.steps_per_epoch,
            async_save=self.cfg.async_checkpoint and not multi)
        if self.cfg.async_checkpoint and multi \
                and not getattr(self, "_warned_sync_save", False):
            self._warned_sync_save = True
            self.print_log("async_checkpoint is synchronous in "
                           "multi-process runs (rank-0 npz saves; orbax "
                           "async saves are collective)")
        self.print_log(f"checkpoint saved: {path}")
