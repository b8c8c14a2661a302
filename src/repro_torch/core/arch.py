"""Architecture model for the port — the hardware facts candidate spaces
are derived from, for an NVIDIA Hopper card or the CPU host.

The paper's premise is that the best directive family (loop transform +
thread count) is a function of the *target machine*.  On the card the
"thread count" is the grain of parallelism: how many CTAs a kernel's tile
choice launches against the SMs, and whether each CTA's tiles fit the
shared memory a block may opt into.  :class:`ArchSpec` holds the numbers
the emit layer (core/emit.py) needs for that: SM count, opt-in shared
memory per block, L2 size, memory bandwidth and peak rates.

:func:`detect` asks torch, never jax: SM count and L2 come from
``torch.cuda.get_device_properties``; bandwidth, peak rates and the
opt-in shared-memory limit (torch only exposes the 48 KB default) come
from a datasheet table keyed by the device name, because SXM and PCIe
parts of one chip differ.  An ArchSpec composes into BasicParams through
``bp_entries()`` (``arch_`` prefix), so emitted spaces are namespaced per
architecture.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

_PREFIX = "arch_"

_FIELDS = (
    "name", "backend", "sm_count", "smem_per_block", "l2_bytes",
    "hbm_bandwidth", "peak_flops", "peak_flops_tf32", "peak_flops_fp32", "warp_size",
    "mma_edge", "wave_overhead_s",
)


@dataclass(frozen=True)
class ArchSpec:
    """One target architecture, as seen by the emit layer.

    ``smem_per_block`` is the shared memory one CTA may opt into
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``); :meth:`vmem_budget`
    returns it whole, because the kernels' ``vmem_model`` counts their real
    shared-memory bytes.  ``peak_flops`` is the dense bf16 tensor-core rate,
    ``peak_flops_tf32`` the dense TF32 tensor-core rate, ``peak_flops_fp32``
    the float32 rate outside the tensor cores.
    ``wave_overhead_s`` is the fixed cost of one wave of CTAs over the SMs.

    The dry-run's roofline also reads the card's capacity and links:
    ``hbm_bytes`` (device memory), ``nvlink_bandwidth`` (NVLink, per GPU
    and direction, between the ``gpus_per_node`` GPUs of one node) and
    ``internode_bandwidth`` (the GPU's network port, per direction, between
    nodes).  They stay out of :meth:`bp_entries` and of equality: no
    kernel's space depends on them, and adding them would re-key every
    tuned entry.
    """

    name: str
    backend: str                        # "cuda" or "cpu"
    sm_count: int = 132
    smem_per_block: int = 232_448
    l2_bytes: int = 50 * 2**20
    hbm_bandwidth: float = 3.35e12      # bytes/s
    peak_flops: float = 989e12          # bf16 dense, tensor cores
    peak_flops_tf32: float = 495e12     # TF32 dense, tensor cores
    peak_flops_fp32: float = 67e12      # float32, CUDA cores
    warp_size: int = 32
    mma_edge: int = 16                  # smallest tensor-core fragment edge
    wave_overhead_s: float = 3e-6
    hbm_bytes: int = dataclasses.field(default=80_000_000_000,  # H100 SXM5: 80 GB HBM3
                                       compare=False)
    nvlink_bandwidth: float = dataclasses.field(default=450e9,  # NVLink 4: 900 GB/s, 2 ways
                                                compare=False)
    internode_bandwidth: float = dataclasses.field(default=50e9,  # one NDR port: 400 Gb/s
                                                   compare=False)
    gpus_per_node: int = dataclasses.field(default=8, compare=False)  # HGX/DGX H100 node

    BP_KEYS: Tuple[str, ...] = dataclasses.field(
        default=_FIELDS, init=False, repr=False, compare=False,
    )

    def vmem_budget(self) -> int:
        """Bytes of shared memory one CTA may plan against."""
        return self.smem_per_block

    def bp_entries(self) -> Dict[str, Any]:
        """This arch as composable BP entries (``arch_`` prefix)."""
        return {_PREFIX + k: getattr(self, k) for k in _FIELDS}

    @classmethod
    def from_bp_entries(cls, entries: Mapping[str, Any]) -> "ArchSpec":
        """Inverse of :meth:`bp_entries` — rebuild from a BP mapping."""
        kwargs = {}
        for k in _FIELDS:
            key = _PREFIX + k
            if key not in entries:
                raise KeyError(f"missing BP entry {key!r}")
            kwargs[k] = entries[key]
        return cls(**kwargs)


# Datasheet rows (NVIDIA H100/H200 data sheets, dense rates): memory
# bandwidth, bf16 and TF32 tensor-core peaks, float32 peak, opt-in shared
# memory per block, memory capacity and the NVLink rate per direction (the
# NVIDIA H100 Tensor Core GPU datasheet: SXM 80 GB and NVLink 900 GB/s,
# PCIe 80 GB and an NVLink bridge of 600 GB/s, NVL 94 GB and 600 GB/s; the
# H200 datasheet: 141 GB and 900 GB/s).  Between nodes every row keeps the
# default: one NDR InfiniBand port a GPU, 400 Gb/s a direction (the NVIDIA
# ConnectX-7 datasheet, as the DGX H100 pairs one with each GPU).  Matched
# by substring of the lower-cased device name, first hit wins.
_DATASHEET: Tuple[Tuple[Tuple[str, ...], Dict[str, Any]], ...] = (
    (("h100", "pcie"), dict(hbm_bandwidth=2.0e12, peak_flops=756e12, peak_flops_tf32=378e12,
                            peak_flops_fp32=51e12, smem_per_block=232_448,
                            hbm_bytes=80_000_000_000, nvlink_bandwidth=300e9)),
    (("h100", "nvl"), dict(hbm_bandwidth=3.9e12, peak_flops=835e12, peak_flops_tf32=417.5e12,
                           peak_flops_fp32=60e12, smem_per_block=232_448,
                           hbm_bytes=94_000_000_000, nvlink_bandwidth=300e9)),
    (("h100",), dict(hbm_bandwidth=3.35e12, peak_flops=989e12, peak_flops_tf32=495e12,
                     peak_flops_fp32=67e12, smem_per_block=232_448,
                     hbm_bytes=80_000_000_000, nvlink_bandwidth=450e9)),
    (("h200",), dict(hbm_bandwidth=4.8e12, peak_flops=989e12, peak_flops_tf32=495e12,
                     peak_flops_fp32=67e12, smem_per_block=232_448,
                     hbm_bytes=141_000_000_000, nvlink_bandwidth=450e9)),
)

# The CPU host runs every kernel's plain PyTorch version; its arch only
# names the backend so CPU shape classes and spaces never collide with a
# card's.  Tile limits are the H100's so a CPU run emits the same points.
CPU_HOST = ArchSpec(name="cpu_host", backend="cpu")


def from_properties(props: Any) -> ArchSpec:
    """Build the ArchSpec of a CUDA device from its torch properties.

    ``props`` is what ``torch.cuda.get_device_properties`` returns (or any
    object with ``name``, ``multi_processor_count``, ``L2_cache_size`` and
    ``shared_memory_per_block``).  A card missing from the datasheet table
    keeps the 48 KB default shared-memory limit, which every CUDA device
    grants without opt-in, and the H100 SXM rates.  A card's memory
    capacity is its own ``total_memory`` where the properties give it.
    """
    name = str(props.name)
    lowered = name.lower()
    row: Dict[str, Any] = {"smem_per_block": int(props.shared_memory_per_block)}
    for keys, values in _DATASHEET:
        if all(k in lowered for k in keys):
            row = dict(values)
            break
    if getattr(props, "total_memory", None):
        row["hbm_bytes"] = int(props.total_memory)
    return ArchSpec(
        name=name,
        backend="cuda",
        sm_count=int(props.multi_processor_count),
        l2_bytes=int(props.L2_cache_size),
        warp_size=int(getattr(props, "warp_size", 32) or 32),
        **row,
    )


def detect(device: Optional[Any] = None) -> ArchSpec:
    """The ArchSpec for ``device`` (default: CUDA device 0 if present).

    A CPU device, or no card at all, gives :data:`CPU_HOST`.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_HOST
    return from_properties(torch.cuda.get_device_properties(device))


_LOCAL: Dict[str, ArchSpec] = {}


def local_arch() -> ArchSpec:
    """The default device's ArchSpec (CUDA device 0, else the CPU host),
    detected once per process."""
    import torch

    key = "cuda:0" if torch.cuda.is_available() else "cpu"
    if key not in _LOCAL:
        _LOCAL[key] = detect(key)
    return _LOCAL[key]
