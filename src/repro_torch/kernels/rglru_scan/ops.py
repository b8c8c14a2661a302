"""AT region and KernelSpec for the RG-LRU scan kernel.

The emitted space is exactly what the kernel takes.  ``block_w`` is the
channels of one CTA, one thread each: a "grid" dim from a warp (32) up to
the 1024 threads a CTA may have.  ``chunk`` is the time steps staged per
loop trip: a "sequential" dim (a loop inside the CTA, adding no CTAs).  A
point survives only if its shared memory fits the card's opt-in limit.

The shape class keeps a power-of-two bucket of the batch (the JAX package
drops it): the card runs ``batch`` times the CTAs of one sequence, so the
hint's CTA count and traffic cover the whole call, and a B = 8 call does
not recall a B = 1 winner.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import rglru_scan_ref
from .rglru_scan import MAX_THREADS, rglru_scan, smem_bytes, traffic

RGLRU_POLICY = TilePolicy(
    kernel="rglru_scan",
    dims=lambda bp: (
        TileDim("block_w", bp["width"], semantic="grid", min_tile=32,
                max_tile=MAX_THREADS),
        TileDim("chunk", bp["seq"], semantic="sequential"),
    ),
    vmem_model=lambda bp, p: smem_bytes(p["block_w"], p["chunk"]),
    traffic_model=lambda bp, p: traffic(bp["batch"], bp["seq"], bp["width"]),
    grid_multiplier=lambda bp: bp["batch"],
)


def rglru_region(
    width: int, seq_len: int, batch: int = 1,
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    arch = arch or local_arch()
    emitted = RGLRU_POLICY.emit(
        arch, {"width": width, "seq": seq_len, "batch": batch}
    )

    def instantiate(point: Mapping[str, Any]):
        bw, ck = point["block_w"], point["chunk"]
        return lambda x, r, i, lam: rglru_scan(x, r, i, lam, block_w=bw, chunk=ck)

    return ATRegion(
        "rglru_scan_cuda", emitted.space, instantiate,
        oracle=rglru_scan_ref, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def shape_class(x, r, i, lam) -> BasicParams:
    """(width, seq) fix the candidate family; the batch enters as a
    power-of-two bucket, which sets the CTA count.  ``framework`` and a
    ``backend`` of ``cuda``/``cpu`` keep the port's keys apart from the JAX
    package's in a shared file."""
    return BasicParams.make(
        kernel="rglru_scan",
        width=int(x.shape[-1]),
        seq=int(x.shape[1]),
        batch=bucket_pow2(int(x.shape[0])),
        dtype=str(x.dtype).replace("torch.", ""),
        backend=x.device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return rglru_region(bp["width"], bp["seq"], bp["batch"], arch=arch)


register_kernel(
    KernelSpec(
        "rglru_scan",
        make_region=_make_region,
        shape_class=shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
