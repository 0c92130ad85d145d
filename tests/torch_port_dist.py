"""Rank processes for the port's multi-rank CPU tests (no JAX here).

`start(jobs, tmp_path)` starts as many processes as the largest job's
world, each

    python -m tests.torch_port_dist <rank> <tmp> <jobs json>

and each rank runs the jobs in order, those whose world it belongs to:
a job joins its ranks over gloo through its own `file://` store under
`tmp` (no port), with a 60 s process-group timeout, and leaves the group
at its end. One torch thread a process. `join(procs)` waits at most
`timeout` seconds for them all, kills every one on a failure, and raises
with the failing rank's output; the caller may work in between (the
JAX references, the one-process run). A job is {"job": ..., "world": N,
...}:

- `edge`: the functions of parallel/edge_partition.py and SyncBN on a
  (`data`, `edge`) mesh, inputs from the npz `inputs`; each rank writes
  its results to `<tmp>/edge_<data>x<edge>_<rank>.npz`.
- `main`: `agcn_tpu_torch.main.main(argv)`, the entry point, in the
  group (its launcher's RANK / WORLD_SIZE / LOCAL_RANK set).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = datetime.timedelta(seconds=60)


def start(jobs, tmp_path):
    world = max(job["world"] for job in jobs)
    jobs = [dict(job, store=os.path.join(str(tmp_path),
                                         f"store_{i}_{time.time_ns()}"))
            for i, job in enumerate(jobs)]
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        # output to a file: a pipe nobody reads while the caller works
        # could fill and stall the rank
        log = open(os.path.join(str(tmp_path), f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port_dist", str(rank),
             str(tmp_path), json.dumps(jobs)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs, timeout=120):
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            if p.returncode != 0:
                # p.args: python -m tests.torch_port_dist rank tmp jobs
                with open(os.path.join(p.args[-2], f"rank{i}.log")) as f:
                    raise RuntimeError(f"rank {i} exited {p.returncode}:\n"
                                       f"{f.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _edge(rank, tmp, spec):
    import torch

    from agcn_tpu_torch.ops.norm import BatchNorm
    from agcn_tpu_torch.parallel import make_mesh
    from agcn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_aggregate, make_edge_partitioned_gcn,
        make_hybrid_partitioned_gcn, model_edge_gcn)

    mesh = make_mesh(data=spec["data"], edge=spec["edge"])
    inp = {k: v for k, v in np.load(spec["inputs"]).items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    adj = inp["adj"]
    for combiner in ("psum", "ppermute"):
        out[f"agg_{combiner}"] = edge_partitioned_aggregate(
            t["x_agg"], adj, mesh, combiner=combiner)
        fn, parts = make_edge_partitioned_gcn(adj, mesh, combiner=combiner)
        out[f"gcn_{combiner}"] = fn(t["x_gcn"], parts, t["w_gcn"])
    fn, parts = make_hybrid_partitioned_gcn(adj, mesh)
    out["hybrid"] = fn(t["x_gcn"], parts, t["w_hybrid"])
    for tag, frames in (("t8", 8), ("t7", 7)):
        x = t["x"][:, :frames].clone().requires_grad_(True)
        a1 = t["a1"].clone().requires_grad_(True)
        w = t["w"].clone().requires_grad_(True)
        y = model_edge_gcn(x, a1, w, mesh)
        (y * t["probe"][:, :frames]).sum().backward()
        out.update({f"model_{tag}": y, f"dx_{tag}": x.grad,
                    f"da1_{tag}": a1.grad, f"dw_{tag}": w.grad})
    if mesh.shape["data"] > 1:
        # SyncBN and Ghost BN over the data axis: data rank d takes its
        # half of the batch
        d, n = mesh.coordinate("data"), mesh.shape["data"]
        for tag, splits in (("sync", 1), ("ghost", 2)):
            bn = BatchNorm(inp["bn_x"].shape[-1], axis_name="data",
                           splits=splits).train()
            with torch.no_grad():
                bn.weight.copy_(t["bn_scale"])
                bn.bias.copy_(t["bn_bias"])
            x = t["bn_x"].chunk(n)[d].clone().requires_grad_(True)
            y = bn(x)
            (y * t["bn_g"].chunk(n)[d]).sum().backward()
            out.update({f"bn_{tag}_y": y, f"bn_{tag}_dx": x.grad,
                        f"bn_{tag}_dscale": bn.weight.grad,
                        f"bn_{tag}_dbias": bn.bias.grad,
                        f"bn_{tag}_mean": bn.running_mean,
                        f"bn_{tag}_var": bn.running_var})
    np.savez(os.path.join(tmp, f"edge_{spec['data']}x{spec['edge']}_"
                                f"{rank}.npz"),
             coords=np.array([mesh.coordinate("data"),
                              mesh.coordinate("edge")]),
             **{k: v.detach().numpy() for k, v in out.items()})


def _run(rank, tmp, jobs):
    import torch
    import torch.distributed as dist

    from agcn_tpu_torch.main import main
    from agcn_tpu_torch.parallel import destroy

    torch.set_num_threads(1)
    for job in jobs:
        if rank >= job["world"]:
            continue
        init = f"file://{job['store']}"
        if job["job"] == "main":
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(job["world"]),
                              LOCAL_RANK=str(rank))
            main(job["argv"], init_method=init, timeout=TIMEOUT)
            continue
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=job["world"], timeout=TIMEOUT)
        try:
            _edge(rank, tmp, job)
        finally:
            destroy()


if __name__ == "__main__":
    _run(int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3]))
