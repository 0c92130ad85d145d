"""agcn_tpu_torch: the PyTorch + CUDA port of agcn_tpu for NVIDIA Hopper.

A package of its own beside the JAX package `agcn_tpu`, which stays the
reference. It imports torch and numpy, never jax, and nothing of
`agcn_tpu`: what it needs from the JAX package's numpy modules it keeps as
its own copy. The layout mirrors `agcn_tpu` module for module; the
compute stays channels-last (B, T, V, C) as there, and the parameters
carry the reference torch names (`l1.gcn1.conv_a.0.weight`, ...).

Entry points run on `cuda` unless the caller passes `device="cpu"`. A
default-device call on a machine without a GPU raises; nothing moves to
the CPU on its own.
"""

__version__ = "0.1.0"
