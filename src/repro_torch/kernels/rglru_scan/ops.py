"""AT region and KernelSpec for the RG-LRU scan kernel.

The emitted space is what the kernel takes, in float32 and bf16, less
the points that waste a warp's lanes.  ``split`` is the threads that
share one channel's sequence (1 to 32, a power of two): it adds threads,
not CTAs.  ``block_w`` is the channels of one CTA: a "grid" dim from a
16-byte row (4 float32 or 8 bf16 channels; narrower rows read a 64-byte
atom for a few bytes) up to 128 (wider CTAs leave most SMs idle at these
widths).  ``chunk`` is the time steps staged per loop trip, ``split``
segments of 4 to 32 steps: a "sequential" dim (a loop inside the CTA)
that need not divide the sequence.  A point survives only if the kernel
takes its ``split`` at its ``chunk`` (:func:`~.rglru_scan.takes_split`),
its ``block_w * split`` threads are whole warps (or the CTA holds the
whole width) within the launch bound, and its two stages of shared memory
fit the card's opt-in limit.

The hint is the larger of the bytes' time and the chain's.  The bytes
count a row narrower than a 64-byte memory atom as the whole atom (a
CTA's rows are ``block_w`` elements at a stride of W).  Each CTA runs
:func:`~.rglru_scan.chain_steps` dependent steps plus a fixed cost a tile
(the wait for its loads, two barriers, the store), and CTAs that share
the busiest SM share its instruction throughput; the constants are fitted
to the sweeps of ``chip_smoke.py`` on an H100.

The shape class keeps a power-of-two bucket of the batch (the JAX package
drops it): the card runs ``batch`` times the CTAs of one sequence, so the
hint's CTA count and traffic cover the whole call, and a B = 8 call does
not recall a B = 1 winner.

``rglru_scan_bwd`` (the backward kernel) is a registry op of its own, with
the forward's class keys and tunables and its point filter on the
backward's shared memory (a fourth tile, dy, a stage).  Its hint is the
larger of the bytes' time (x, r, i, dy read; dx, dr, di written) and the
chain's: per tile, sweep 1's pass over a thread's segment and its join,
and sweep 2's four passes (the forward's two, the adjoint's composition,
the gradients) and two joins, at the forward's STEP_S and TILE_S.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import rglru_scan_bwd_ref, rglru_scan_ref
from .rglru_scan import (
    COMBINE_STEPS, DTYPES, MAX_SPLIT, MAX_THREADS, SEGMENTS, WARP, bwd_max_threads,
    bwd_smem_bytes, bwd_traffic,
    chain_steps, rglru_scan, rglru_scan_bwd, seg_len, smem_bytes, takes_split, traffic,
)

_ELT = {str(dt).replace("torch.", ""): elt for dt, elt in DTYPES.items()}
BLOCK_W_MAX = 128

# The chain's costs on an H100 SXM, fitted to the sweeps of chip_smoke.py
# at recurrentgemma-2b width (f32 and bf16, 206 points): one step of a
# thread's segment (phase A or C), and a tile's fixed part.  With them the
# hint's finals hold a point within 6% of the fastest swept one in both
# dtypes.
STEP_S = 10e-9
TILE_S = 0.6e-6
ATOM = 64  # bytes the memory reads for any part of an aligned 64-byte run
ROW_MIN = 16  # bytes of the narrowest emitted row: one 16-byte cp.async piece


def _elt(bp: Mapping[str, Any]) -> int:
    return _ELT.get(bp.get("dtype", "float32"), 4)


def _takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    threads = point["block_w"] * point["split"]
    whole = threads % WARP == 0 or point["block_w"] == bp["width"]
    return takes_split(point["chunk"], point["split"]) and whole and threads <= MAX_THREADS


def _latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """One CTA's chain, times the CTAs that share the busiest SM."""
    chunk = point["chunk"]
    chain = (chain_steps(bp["seq"], chunk, point["split"]) * STEP_S
             + -(-bp["seq"] // chunk) * TILE_S)
    ctas = bp["batch"] * (bp["width"] // point["block_w"])
    return chain * -(-ctas // arch.sm_count)


def _traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the call, a row narrower than an ATOM counted as
    the whole atom (the bytes the memory moves, for ranking)."""
    row = point["block_w"] * _elt(bp)
    flops, bytes_ = traffic(bp["batch"], bp["seq"], bp["width"], _elt(bp))
    return flops, bytes_ * ATOM * -(-row // ATOM) / row


RGLRU_POLICY = TilePolicy(
    kernel="rglru_scan",
    dims=lambda bp: (
        TileDim("block_w", bp["width"], semantic="grid", min_tile=ROW_MIN // _elt(bp),
                max_tile=BLOCK_W_MAX),
        TileDim("chunk", bp["seq"], semantic="sequential", min_tile=SEGMENTS[0],
                max_tile=SEGMENTS[-1] * MAX_SPLIT, allow_padding=True),
        TileDim("split", MAX_SPLIT, semantic="sequential", min_tile=1, pow2_only=True),
    ),
    vmem_model=lambda bp, p: smem_bytes(p["block_w"], p["chunk"], p["split"], _elt(bp)),
    traffic_model=_traffic,
    grid_multiplier=lambda bp: bp["batch"],
    latency_model=_latency,
    point_filter=_takes,
)


def rglru_region(
    width: int, seq_len: int, batch: int = 1,
    arch: Optional[ArchSpec] = None, dtype: str = "float32",
) -> ATRegion:
    arch = arch or local_arch()
    emitted = RGLRU_POLICY.emit(
        arch, {"width": width, "seq": seq_len, "batch": batch, "dtype": dtype}
    )

    def instantiate(point: Mapping[str, Any]):
        bw, ck, sp = point["block_w"], point["chunk"], point["split"]
        return lambda x, r, i, lam: rglru_scan(x, r, i, lam, block_w=bw, chunk=ck, split=sp)

    return ATRegion(
        "rglru_scan_cuda", emitted.space, instantiate,
        oracle=rglru_scan_ref, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def shape_class(x, r, i, lam, kernel: str = "rglru_scan") -> BasicParams:
    """(width, seq, dtype) fix the candidate family; the batch enters as a
    power-of-two bucket, which sets the CTA count.  ``framework`` and a
    ``backend`` of ``cuda``/``cpu`` keep the port's keys apart from the JAX
    package's in a shared file."""
    return BasicParams.make(
        kernel=kernel,
        width=int(x.shape[-1]),
        seq=int(x.shape[1]),
        batch=bucket_pow2(int(x.shape[0])),
        dtype=str(x.dtype).replace("torch.", ""),
        backend=x.device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return rglru_region(bp["width"], bp["seq"], bp["batch"], arch=arch, dtype=bp["dtype"])


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


# -- the backward kernel ----------------------------------------------------------


def bwd_chain_steps(S: int, chunk: int, split: int) -> float:
    """Dependent steps on one backward CTA's chain: per tile, sweep 1's pass
    over a thread's segment and one join, sweep 2's four passes and two
    joins (the forward's and the adjoint's)."""
    tiles = -(-S // chunk)
    joins = (split.bit_length() - 1) * COMBINE_STEPS
    return tiles * (5.0 * seg_len(chunk, split) + 3 * joins)


def _bwd_takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    chunk = min(point["chunk"], bp["seq"])
    return (_takes(bp, point)
            and point["block_w"] * point["split"] <= bwd_max_threads(chunk, point["split"]))


def _bwd_latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """One CTA's chain, times the CTAs that share the busiest SM."""
    chunk = point["chunk"]
    chain = (bwd_chain_steps(bp["seq"], chunk, point["split"]) * STEP_S
             + 2 * -(-bp["seq"] // chunk) * TILE_S)
    ctas = bp["batch"] * (bp["width"] // point["block_w"])
    return chain * -(-ctas // arch.sm_count)


def _bwd_traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the call, a row narrower than an ATOM counted as
    the whole atom, and sweep 1's second read of x, r and i."""
    row = point["block_w"] * _elt(bp)
    flops, bytes_ = bwd_traffic(bp["batch"], bp["seq"], bp["width"], _elt(bp))
    bytes_ += 3.0 * _elt(bp) * bp["batch"] * bp["seq"] * bp["width"]
    return flops, bytes_ * ATOM * -(-row // ATOM) / row


RGLRU_BWD_POLICY = TilePolicy(
    kernel="rglru_scan_bwd",
    dims=RGLRU_POLICY.dims,
    vmem_model=lambda bp, p: bwd_smem_bytes(p["block_w"], p["chunk"], p["split"], _elt(bp)),
    traffic_model=_bwd_traffic,
    grid_multiplier=lambda bp: bp["batch"],
    latency_model=_bwd_latency,
    point_filter=_bwd_takes,
)


def rglru_bwd_region(
    width: int, seq_len: int, batch: int = 1,
    arch: Optional[ArchSpec] = None, dtype: str = "float32",
) -> ATRegion:
    arch = arch or local_arch()
    emitted = RGLRU_BWD_POLICY.emit(
        arch, {"width": width, "seq": seq_len, "batch": batch, "dtype": dtype}
    )

    def instantiate(point: Mapping[str, Any]):
        bw, ck, sp = point["block_w"], point["chunk"], point["split"]
        return lambda x, r, i, lam, dy: rglru_scan_bwd(x, r, i, lam, dy, block_w=bw, chunk=ck,
                                                       split=sp)

    return ATRegion(
        "rglru_scan_bwd_cuda", emitted.space, instantiate,
        oracle=rglru_scan_bwd_ref, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def bwd_shape_class(x, r, i, lam, dy) -> BasicParams:
    """The forward's class keys (width, seq, batch bucket, dtype, device)."""
    return shape_class(x, r, i, lam, kernel="rglru_scan_bwd")


def _make_bwd_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return rglru_bwd_region(bp["width"], bp["seq"], bp["batch"], arch=arch, dtype=bp["dtype"])


register_kernel(
    KernelSpec(
        "rglru_scan_bwd",
        make_region=_make_bwd_region,
        shape_class=bwd_shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
