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
backward's launch bound and shared memory (one trip's x, r, i and dy).
Every (batch row, trip, channel block) runs in a CTA of its own in each of
its two trip passes, so the hint counts the CTAs an SM holds at once (by
shared memory, threads and the gradient pass's registers) and the rounds
of them the items take.  Its hint is the larger of the bytes' time (x, r,
i and dy read twice, dx, dr and di written once, and the trips' scratch)
and the latency: the bytes' time stretched by the last round's idle
slots, each round's chain of an item (:func:`bwd_chain_steps`) and fixed
part, and the chain pass's walk over the trips, at constants fitted to
the sweeps of ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import rglru_scan_bwd_ref, rglru_scan_ref
from .rglru_scan import (
    COMBINE_STEPS, DTYPES, MAX_SPLIT, MAX_THREADS, SEGMENTS, WARP, bwd_max_threads,
    bwd_scratch_bytes, bwd_smem_bytes, bwd_traffic, bwd_trips,
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

# The backward's costs on an H100 SXM, fitted to the sweeps of chip_smoke.py
# at recurrentgemma-2b width (f32 and bf16, B = 1 and 2; with them the
# staged pick is within 1% of the fastest swept point at all three): a step
# of a thread's segment, an item's fixed part (its loads' latency before it
# computes, its barriers and store) in a round of the CTAs the SMs hold at
# once, and one group of CHAIN_GROUP trips in the chain pass (a load's
# latency).
BWD_STEP_S = 40e-9
BWD_ITEM_S = 1.0e-6
BWD_CHAIN_S = 1.0e-6
CHAIN_GROUP = 32  # trips whose maps the chain pass loads at once (kGroup in the source)
SM_THREADS = 2048
SM_REGISTERS = 65536
# Registers a thread of the compiled gradient pass takes, by segment
# length (its [ptxas] lines in chip_smoke.py, float32; bf16 within 9)
BWD_REGISTERS = {4: 51, 8: 64, 16: 122, 32: 214}


def bwd_chain_steps(chunk: int, split: int) -> float:
    """Dependent steps of one item's chain over both trip passes: the maps
    pass's two walks over a thread's segment (the forward map, the
    adjoint's) and its scans (up and down together), the gradient pass's
    four walks (the two maps again, the rerun, the gradients) and its
    scans."""
    joins = (split.bit_length() - 1) * COMBINE_STEPS
    return 6.0 * seg_len(chunk, split) + 2 * joins


def _bwd_takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    chunk = min(point["chunk"], bp["seq"])
    return (_takes(bp, point)
            and point["block_w"] * point["split"] <= bwd_max_threads(chunk, point["split"]))


def _bwd_items(bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    """CTAs of each of the two trip passes: one a (batch row, trip,
    channel block)."""
    trips = bwd_trips(bp["seq"], min(point["chunk"], bp["seq"]))
    return bp["batch"] * trips * (bp["width"] // point["block_w"])


def _bwd_resident(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    """Gradient-pass CTAs one SM holds at once: by their shared memory (and
    the 1 KiB a CTA reserves), threads and registers."""
    chunk = min(point["chunk"], bp["seq"])
    threads = point["block_w"] * point["split"]
    smem = bwd_smem_bytes(point["block_w"], chunk, point["split"], _elt(bp))
    regs = BWD_REGISTERS[seg_len(chunk, point["split"])] * threads
    return max(1, min((arch.smem_per_block + 1024) // (smem + 1024), SM_THREADS // threads,
                      SM_REGISTERS // regs))


def _bwd_programs(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    """The CTAs at work at once: the hint's waves are its rounds."""
    return min(_bwd_items(bp, point), arch.sm_count * _bwd_resident(arch, bp, point))


def _bwd_latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """The bytes' time stretched by the last round's idle slots; each
    round's chain of an item (:func:`bwd_chain_steps`) and its fixed part in
    both passes; and the chain pass: a load's latency for each CHAIN_GROUP
    trips, each way."""
    chunk = min(point["chunk"], bp["seq"])
    trips = bwd_trips(bp["seq"], chunk)
    items, programs = _bwd_items(bp, point), _bwd_programs(arch, bp, point)
    whole = -(-items // programs)
    bytes_s = _bwd_traffic(bp, point)[1] / arch.hbm_bandwidth
    chain = 2 * -(-trips // CHAIN_GROUP) * BWD_CHAIN_S if trips > 1 else 0.0
    per_round = bwd_chain_steps(chunk, point["split"]) * BWD_STEP_S + 2 * BWD_ITEM_S
    return bytes_s * whole * programs / items + whole * per_round + chain


def _bwd_traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the call: the maps pass's read of x, r, i and dy
    beside the gradient pass's bytes, a row narrower than an ATOM counted
    as the whole atom; and the scratch, each of its four (B, trips, W)
    arrays written and read about three times in all."""
    B, S, W, elt = bp["batch"], bp["seq"], bp["width"], _elt(bp)
    row = point["block_w"] * elt
    flops, bytes_ = bwd_traffic(B, S, W, elt)
    bytes_ = (bytes_ + 4.0 * elt * B * S * W) * ATOM * -(-row // ATOM) / row
    return flops, bytes_ + 3.0 * bwd_scratch_bytes(B, S, W, min(point["chunk"], S))


RGLRU_BWD_POLICY = TilePolicy(
    kernel="rglru_scan_bwd",
    dims=RGLRU_POLICY.dims,
    vmem_model=lambda bp, p: bwd_smem_bytes(p["block_w"], p["chunk"], p["split"], _elt(bp)),
    traffic_model=_bwd_traffic,
    grid_multiplier=lambda bp: bp["batch"],
    latency_model=_bwd_latency,
    point_filter=_bwd_takes,
    programs_model=_bwd_programs,
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
