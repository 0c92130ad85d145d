"""Process groups and the (data, edge) mesh (counterpart of
agcn_tpu/parallel/mesh.py).

The JAX package lays one `jax.sharding.Mesh` over every device and lets
XLA emit the collectives. The port runs one process per card, as the
reference's DDP does (SURVEY.md:157): a launcher (`torchrun`) starts the
processes and sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and
`MASTER_PORT` (the role of JAX's `JAX_COORDINATOR_ADDRESS` /
`JAX_PROCESS_ID`, root main.py:36-49). `init_distributed` joins them into
one process group (NCCL on cuda, gloo for `device: cpu`) and `make_mesh`
lays the ranks out as a (data, edge) grid, row-major like JAX's
`reshape(data, edge)`: rank = d * edge + e. Axes:

- 'data': batch parallel. The trainer wraps the model in
  DistributedDataParallel over this axis' group, and every BatchNorm
  takes its statistics over it (ops/norm.py: SyncBN), as GSPMD computes
  them over the global batch.
- 'edge': the edge-partitioned graph aggregation
  (parallel/edge_partition.py).

One JAX process is one port data coordinate: `batch_size` is per data
rank and the global batch is batch_size x data, as in JAX's `shard_batch`
(global batch = local batch x process_count) and the reference's
per-GPU DataLoader. The ranks of one data coordinate's edge axis load the
same rows. JAX's single-process mesh over several local devices has no
counterpart here: a process drives one card, so a run on N cards is N
processes.

`make_mesh` binds its mesh to the process: a BatchNorm with `axis_name`
finds its group there, as a JAX collective finds its axis in the
enclosing `shard_map`; without a bound mesh it raises JAX's NameError.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from agcn_tpu_torch.utils.device import resolve_device

AXES = ("data", "edge")

_BOUND: Optional["Mesh"] = None


class Mesh:
    """A (data, edge) grid of the world's ranks.

    `shape` maps each axis to its size, as a JAX mesh's does; `group` and
    `coordinate` give this rank's process group and index along an
    axis. A 1 x 1 mesh without a process group (a run
    that no launcher started) has no groups: its collectives are the
    identity.
    """

    def __init__(self, data: int, edge: int, device_mesh: Any = None):
        self.shape: Dict[str, int] = {"data": data, "edge": edge}
        self.device_mesh = device_mesh

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, edge={self.shape['edge']})"


def launcher_world() -> Optional[int]:
    """`WORLD_SIZE` as a launcher set it, or None outside one."""
    value = os.environ.get("WORLD_SIZE")
    return None if value in (None, "") else int(value)


def distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def is_main() -> bool:
    """Rank 0 (or a run without a process group) owns the work dir's
    artifacts, as JAX's process 0 does (trainer.py:56)."""
    return rank() == 0


def check_world(cfg) -> int:
    """The world size of a recipe's run: the launcher's `WORLD_SIZE`, or 1
    without a launcher. A recipe `world_size` above 1 must equal it, and
    without a launcher it raises: the port never runs one process where
    the recipe asks for more. `world_size: 1`, the default, takes the
    launcher's count. A `device` list names the reference's cards for
    mp.spawn; here a launcher starts one process a card."""
    launched = launcher_world()
    asked = int(cfg.world_size or 1)
    devices = cfg.device if isinstance(cfg.device, (list, tuple)) else None
    if launched is None:
        if asked > 1:
            raise RuntimeError(
                f"world_size {asked} but no launcher set WORLD_SIZE: start "
                f"the run with torchrun --nproc-per-node {asked}")
        if devices is not None and len(devices) > 1:
            raise RuntimeError(
                f"device {list(devices)}: one process drives one card; start "
                f"the run with torchrun --nproc-per-node {len(devices)}")
        return 1
    if asked > 1 and asked != launched:
        raise RuntimeError(
            f"world_size {asked} in the recipe but WORLD_SIZE {launched} from "
            "the launcher")
    return launched


def rank_device(value: Any) -> torch.device:
    """The card of this rank under a launcher: cuda:LOCAL_RANK, or the CPU
    for `device: cpu`."""
    if str(value).lower().startswith("cpu"):
        return torch.device("cpu")
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def init_distributed(cfg, init_method: str = "env://",
                     timeout: Optional[datetime.timedelta] = None
                     ) -> Optional[torch.device]:
    """Join the launcher's process group, if a launcher started this
    process: NCCL on the rank's card (cuda:LOCAL_RANK), gloo for `device:
    cpu`. Returns the rank's device, or None without a launcher (no
    process group is made). Raises as `check_world` does, and when the
    group cannot be formed."""
    world = check_world(cfg)
    if launcher_world() is None:
        return None
    device = rank_device(cfg.device)
    if distributed():
        return device
    kwargs: Dict[str, Any] = {}
    if timeout is not None:
        kwargs["timeout"] = timeout
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        rank=int(os.environ["RANK"]), world_size=world, **kwargs)
    return device


def mesh_shape(data: int, edge: int, world: int):
    """(data, edge) of a grid over `world` ranks: `data` 0 means world //
    edge, as a recipe's `mesh_data: 0` does (agcn_tpu trainer.py:81); a
    grid that is not the world raises."""
    edge = max(int(edge or 1), 1)
    data = int(data or 0) or world // edge
    if data * edge != world:
        raise ValueError(
            f"mesh_data {data} x mesh_edge {edge} = {data * edge} ranks, but "
            f"the world has {world}")
    return data, edge


def make_mesh(data: int = 0, edge: int = 1) -> Mesh:
    """The (data, edge) mesh over the process group's ranks (`mesh_shape`),
    built with init_device_mesh and bound to the process. Without a
    process group only 1 x 1 is possible."""
    data, edge = mesh_shape(data, edge, world_size())
    device_mesh = None
    if distributed():
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(kind, (data, edge),
                                       mesh_dim_names=AXES)
    global _BOUND
    _BOUND = Mesh(data, edge, device_mesh)
    return _BOUND


def axis_group(name: str):
    """The process group of the bound mesh's axis `name` (None on a
    one-rank mesh without a process group). NameError without a bound
    mesh or such an axis, as JAX raises for an unbound axis name."""
    if _BOUND is None or name not in _BOUND.shape:
        raise NameError(f"unbound axis name: {name}")
    return _BOUND.group(name)


def destroy() -> None:
    """Unbind the mesh and leave the process group."""
    global _BOUND
    _BOUND = None
    if distributed():
        dist.destroy_process_group()


def interleave(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Reassemble the per-data-rank rows of a sharded loader: block p
    holds the padded samples p, p + P, p + 2P, ... (BatchIterator's
    shards), so row i of block p is sample i * P + p (JAX trainer
    :762-784; the reference's all_gather_object and round-robin,
    processor.py:862-868)."""
    p = len(blocks)
    out = np.empty((p * blocks[0].shape[0],) + blocks[0].shape[1:],
                   blocks[0].dtype)
    for i, block in enumerate(blocks):
        out[i::p] = block
    return out


def gather_rows(rows: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Every data rank's `rows` (equal shapes), all-gathered over the data
    axis and interleaved into the loader's padded sample order."""
    group = mesh.group("data")
    if group is None or mesh.shape["data"] == 1:
        return rows
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    parts = [torch.empty_like(mine) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, mine, group=group)
    return interleave([t.cpu().numpy() for t in parts])
