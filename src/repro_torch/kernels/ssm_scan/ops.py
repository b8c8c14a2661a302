"""AT region and KernelSpec for the selective-scan kernel.

The emitted space is exactly what the kernel takes.  ``block_d`` is the
channels of one CTA, N threads each: a "grid" dim whose ladder runs from
one warp (``32 / N`` channels) to the 1024 threads a CTA may have
(``1024 / N``).  ``chunk`` is the time steps staged per loop trip: a
"sequential" dim (a loop inside the CTA, adding no CTAs).  A point survives
only if its shared memory fits the card's opt-in limit.

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
from .ref import ssm_scan_ref
from .ssm_scan import MAX_THREADS, WARP, smem_bytes, ssm_scan, traffic

SSM_POLICY = TilePolicy(
    kernel="ssm_scan",
    dims=lambda bp: (
        TileDim("block_d", bp["d_inner"], semantic="grid",
                min_tile=max(1, WARP // bp["n_state"]),
                max_tile=max(1, MAX_THREADS // bp["n_state"])),
        TileDim("chunk", bp["seq"], semantic="sequential"),
    ),
    vmem_model=lambda bp, p: smem_bytes(p["block_d"], p["chunk"], bp["n_state"]),
    traffic_model=lambda bp, p: traffic(
        bp["batch"], bp["seq"], bp["d_inner"], bp["n_state"]
    ),
    grid_multiplier=lambda bp: bp["batch"],
)


def ssm_region(
    d_inner: int, seq_len: int, n_state: int, batch: int = 1,
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    arch = arch or local_arch()
    emitted = SSM_POLICY.emit(
        arch,
        {"d_inner": d_inner, "seq": seq_len, "n_state": n_state, "batch": batch},
    )

    def instantiate(point: Mapping[str, Any]):
        bd, ck = point["block_d"], point["chunk"]
        return lambda x, dt, A, Bc, Cc, D: ssm_scan(x, dt, A, Bc, Cc, D,
                                                    block_d=bd, chunk=ck)

    return ATRegion(
        "ssm_scan_cuda", emitted.space, instantiate, oracle=ssm_scan_ref,
        space_signature=emitted.signature, hints=emitted.hints, arch=arch,
    )


def shape_class(x, dt, A, Bc, Cc, D) -> BasicParams:
    """(d_inner, seq, n_state) fix the candidate family; the batch enters
    as a power-of-two bucket, which sets the CTA count.  ``framework`` and
    a ``backend`` of ``cuda``/``cpu`` keep the port's keys apart from the
    JAX package's in a shared file."""
    return BasicParams.make(
        kernel="ssm_scan",
        d_inner=int(x.shape[-1]),
        seq=int(x.shape[1]),
        n_state=int(A.shape[-1]),
        batch=bucket_pow2(int(x.shape[0])),
        dtype=str(x.dtype).replace("torch.", ""),
        backend=x.device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return ssm_region(bp["d_inner"], bp["seq"], bp["n_state"], bp["batch"], arch=arch)


register_kernel(
    KernelSpec(
        "ssm_scan",
        make_region=_make_region,
        shape_class=shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
