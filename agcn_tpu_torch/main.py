"""Training / test entry point of the port (counterpart of the root
main.py and of the reference's main.py).

    python -m agcn_tpu_torch.main --config configs/ntu60_xview/train_joint.yaml
    python -m agcn_tpu_torch.main --config ... --phase test \\
        --weights work_dir/.../checkpoints/epoch_50.pt

Runs on `cuda` (the recipes' `device: 0`) unless `--device cpu` is
passed; every flag of the recipe's config can be given on the command
line (`--base-lr 0.05`, `--model-args '{formulation: pallas}'`).
"""

from __future__ import annotations


def main(argv=None):
    from agcn_tpu_torch.train.trainer import Trainer
    from agcn_tpu_torch.utils.config import config_from_cli

    Trainer(config_from_cli(argv)).start()


if __name__ == "__main__":
    main()
