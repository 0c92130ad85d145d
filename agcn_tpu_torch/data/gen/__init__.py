"""Skeleton data preparation (numpy), copied from agcn_tpu/data/gen."""
