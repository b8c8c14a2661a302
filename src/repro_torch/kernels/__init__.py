"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported.

* exb             — GKV exb_realspcal (the paper's §III tuning target)
* flash_attention — causal GQA flash attention, forward

Each package: <name>.py (the wrapper: CUDA launch on CUDA tensors, the
plain PyTorch version on CPU tensors, a launch counter), ops.py (emit
policy, AT region, KernelSpec), ref.py (the plain version and inputs).
The sources are under ``repro_torch/csrc``; ``_build`` compiles them with
nvcc at first use.
"""

# Importing the subpackages registers each kernel's KernelSpec with the
# port's registry (repro_torch.core.registry), which also lazy-imports
# this module on a name miss — so `autotuned("exb")` works either way.
from . import exb, flash_attention  # noqa: E402,F401
