"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported.

* exb             — GKV exb_realspcal (the paper's §III tuning target)
* flash_attention — causal GQA flash attention, forward (with the
                    softmax's log-sum-exp for training) and backward
* stress          — Seism3D update_stress (the paper's §IV tuning target)
* ssm_scan        — Mamba-1 selective scan
* rglru_scan      — RG-LRU recurrence (recurrentgemma)
* loop_nest       — the paper's loop-exchange variants as launch shapes,
                    with the GKV and Seism3D bodies (repro_torch.apps)

Each package: <name>.py (the wrapper: CUDA launch on CUDA tensors, the
plain PyTorch version on CPU tensors, a launch counter), ops.py (emit
policy, AT region, KernelSpec), ref.py (the plain version and inputs);
loop_nest has no ops.py: its region is the apps' LoopNest
(repro_torch.core.exchange).
The sources are under ``repro_torch/csrc``; ``_build`` compiles them with
nvcc at first use.
"""

# Importing the subpackages registers each kernel's KernelSpec with the
# port's registry (repro_torch.core.registry), which also lazy-imports
# this module on a name miss — so `autotuned("exb")` works either way.
from . import exb, flash_attention, rglru_scan, ssm_scan, stress  # noqa: E402,F401
