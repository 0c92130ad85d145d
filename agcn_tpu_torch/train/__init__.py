"""Training: losses, the SGD chain and LR schedule, train/eval steps,
checkpoints and the `Trainer` (port of agcn_tpu/train)."""
