"""AT region and KernelSpec for the exb kernel.

``exb_region()`` brackets the kernel's (block_iv, block_iz, split) family
like the paper brackets the Fortran loop nest; the family is emitted from
the card's ArchSpec (core/emit.py).  (block_iv, block_iz) is the paper's
grain; ``split`` (a "pieces" dim) cuts each plane into that many pieces,
one CTA each: powers of two while a piece keeps :data:`MIN_PIECE`
elements (two for each thread of a warp) and the call at most
:data:`MAX_CTAS_PER_SM` CTAs for each SM of the card.  Unlike the JAX
package, which ranked and costed exb with a TPU analytic model because its
host had no target hardware, the port measures wall-clock on the card and
prescreens on the emit hints, whose SM-fill term keeps the many-CTA
candidates alive.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .exb import exb, plane_elements, traffic
from .ref import exb_ref

MIN_PIECE = 64  # elements of a piece: two for each thread of one warp
MAX_CTAS_PER_SM = 8  # CTAs of 256 threads an SM holds (2048 threads)


def _split_cap(bp: Mapping[str, Any]) -> int:
    """The largest power of two that leaves a piece MIN_PIECE elements."""
    pieces = max(1, plane_elements(bp["mx"] * bp["my"]) // MIN_PIECE)
    return 1 << (pieces.bit_length() - 1)


def _ctas(bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    return (bp["iv"] // point["block_iv"]) * (bp["iz"] // point["block_iz"]) * point["split"]


EXB_POLICY = TilePolicy(
    kernel="exb",
    dims=lambda bp: (
        TileDim("block_iv", bp["iv"], semantic="grid"),
        TileDim("block_iz", bp["iz"], semantic="grid"),
        TileDim("split", plane_elements(bp["mx"] * bp["my"]), semantic="pieces",
                min_tile=1, max_tile=_split_cap(bp), allow_padding=True, pow2_only=True),
    ),
    # no shared memory: the 3-D fields are reused from registers
    vmem_model=lambda bp, p: 0,
    traffic_model=lambda bp, p: traffic(
        bp["iv"], bp["iz"], bp["mx"], bp["my"], p["block_iv"]
    ),
    point_filter=lambda bp, p: p["split"] == 1 or _ctas(bp, p) <= bp["max_ctas"],
)


def exb_region(
    dims=(16, 16, 128, 65),
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    iv, iz, mx, my = dims
    arch = arch or local_arch()
    emitted = EXB_POLICY.emit(arch, {"iv": iv, "iz": iz, "mx": mx, "my": my,
                                     "max_ctas": MAX_CTAS_PER_SM * arch.sm_count})

    def instantiate(point: Mapping[str, Any]):
        biv, biz, split = point["block_iv"], point["block_iz"], point["split"]
        return lambda inp: exb(inp, block_iv=biv, block_iz=biz, split=split)

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
