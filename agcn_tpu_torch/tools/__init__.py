"""Measurement tools of the port, run as `python -m agcn_tpu_torch.tools.X`."""
