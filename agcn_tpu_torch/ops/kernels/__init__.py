"""Hand-written Hopper kernels of the port (CUDA C++ under ../csrc/),
each beside its plain PyTorch version and a count of its launches."""
