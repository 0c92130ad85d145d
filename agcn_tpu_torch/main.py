"""Training / test entry point of the port (counterpart of the root
main.py and of the reference's main.py).

    python -m agcn_tpu_torch.main --config configs/ntu60_xview/train_joint.yaml
    python -m agcn_tpu_torch.main --config ... --phase test \\
        --weights work_dir/.../checkpoints/epoch_50.pt

Runs on `cuda` (the recipes' `device: 0`) unless `--device cpu` is
passed; every flag of the recipe's config can be given on the command
line (`--base-lr 0.05`, `--model-args '{formulation: pallas}'`).

On several cards, one process a card, started by torchrun (the
reference's DDP; the recipe's `world_size`, if above 1, must match):

    torchrun --standalone --nproc-per-node 4 -m agcn_tpu_torch.main \
        --config configs/ntu60_xview/train_joint.yaml

trains data-parallel with `batch_size` per card (the global batch is 4
times it); `configs/ntu60_xview/train_joint_mesh_edge.yaml` (`mesh_edge:
2`) lays the four ranks out as data 2 x edge 2. `--device cpu` joins the
ranks over gloo instead of NCCL. The process group is made before the
trainer (`parallel.init_distributed`) and left at the end; without a
launcher no process group is made.
"""

from __future__ import annotations

import datetime
from typing import Optional


def main(argv=None, init_method: str = "env://",
         timeout: Optional[datetime.timedelta] = None):
    """Run the recipe of `argv`; under a launcher, in its process group
    (`init_method` and `timeout` as torch.distributed takes them)."""
    from agcn_tpu_torch.parallel import destroy, init_distributed
    from agcn_tpu_torch.train.trainer import Trainer
    from agcn_tpu_torch.utils.config import config_from_cli

    cfg = config_from_cli(argv)
    init_distributed(cfg, init_method, timeout)
    try:
        Trainer(cfg).start()
    finally:
        destroy()


if __name__ == "__main__":
    main()
