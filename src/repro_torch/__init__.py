"""repro_torch — the PyTorch/CUDA port of the ppOpen-AT reproduction.

It sits beside the JAX package ``repro`` and imports nothing of it: the
stdlib-only modules it needs are its own copies.  Kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use; each has
a plain PyTorch version that runs on CPU tensors.
"""
