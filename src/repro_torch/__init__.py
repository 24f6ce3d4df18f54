"""repro_torch — the PyTorch/CUDA port of the COKE reproduction.

A second package beside the JAX reference `repro`, with the same
sub-layout. It imports torch and numpy, never jax and nothing of `repro`.
Its kernels are hand-written CUDA C++ for Hopper (`csrc/`), built with
nvcc at first use (`kernels/build.py`); each has a plain PyTorch version
that runs for CPU tensors. Entry points run on the card unless the caller
passes device="cpu" (see `device.py`).
"""
