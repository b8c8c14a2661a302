"""AT region and KernelSpec for the exb kernel.

``exb_region()`` brackets the kernel's (block_iv, block_iz) family exactly
like the paper brackets the Fortran loop nest; the family is emitted from
the card's ArchSpec (core/emit.py).  Unlike the JAX package, which ranked
and costed exb with a TPU analytic model because its host had no target
hardware, the port measures wall-clock on the card and prescreens on the
emit hints, whose SM-fill term keeps the many-CTA candidates alive.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .exb import exb, traffic
from .ref import exb_ref

EXB_POLICY = TilePolicy(
    kernel="exb",
    dims=lambda bp: (
        TileDim("block_iv", bp["iv"], semantic="grid"),
        TileDim("block_iz", bp["iz"], semantic="grid"),
    ),
    # no shared memory: the 3-D fields are reused from registers
    vmem_model=lambda bp, p: 0,
    traffic_model=lambda bp, p: traffic(
        bp["iv"], bp["iz"], bp["mx"], bp["my"], p["block_iv"]
    ),
)


def exb_region(
    dims=(16, 16, 128, 65),
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    iv, iz, mx, my = dims
    arch = arch or local_arch()
    emitted = EXB_POLICY.emit(arch, {"iv": iv, "iz": iz, "mx": mx, "my": my})

    def instantiate(point: Mapping[str, Any]):
        biv, biz = point["block_iv"], point["block_iz"]
        return lambda inp: exb(inp, block_iv=biv, block_iz=biz)

    return ATRegion(
        "exb_cuda", emitted.space, instantiate, oracle=exb_ref,
        space_signature=emitted.signature, hints=emitted.hints, arch=arch,
    )


def shape_class(inp) -> BasicParams:
    """The DB key.  ``framework`` and a ``backend`` of ``cuda``/``cpu``
    keep the port's keys apart from the JAX package's in a shared file."""
    iz, mx, my = inp["ex_re"].shape
    return BasicParams.make(
        kernel="exb",
        iv=int(inp["vl"].shape[0]),
        iz=int(iz),
        mx=int(mx),
        my=int(my),
        dtype=str(inp["ex_re"].dtype).replace("torch.", ""),
        backend=inp["ex_re"].device.type,
        framework="torch",
    )


def arch_of(bp: BasicParams) -> ArchSpec:
    return local_arch() if bp["backend"] == "cuda" else CPU_HOST


def _make_region(bp: BasicParams) -> ATRegion:
    return exb_region(dims=(bp["iv"], bp["iz"], bp["mx"], bp["my"]), arch=arch_of(bp))


register_kernel(
    KernelSpec(
        "exb",
        make_region=_make_region,
        shape_class=shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
