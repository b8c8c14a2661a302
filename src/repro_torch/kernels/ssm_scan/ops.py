"""AT region and KernelSpec for the selective-scan kernel.

The emitted space is exactly what the kernel takes, in float32 and bf16,
at any state size N up to 256, which the kernel runs as NP, N rounded up
to a power of two.  ``states`` is the states one thread carries (1 to 16,
dividing NP, with ``NP / states`` at most a warp's 32 lanes a channel): a
compile-time instantiation that adds no CTAs.  ``block_d`` is the channels
of one CTA, ``NP / states`` threads each: a "grid" dim from one warp at one
state a thread (``32 / NP`` channels) up to the widest CTA any ``states``
takes.  ``chunk`` is the time steps staged per loop trip: a "sequential"
dim (a loop inside the CTA) from a warp's 32 to 256, which need not divide
the sequence.  A point survives only if its threads are whole warps
within the kernel's launch bound for its ``states``, its chunk a whole
number of the kernel's groups of ``32 / states`` steps (or the whole
sequence), and its two stages of shared memory fit the card's opt-in
limit.

The hint is the largest of the bytes' time, the SFU's (one exp per
(t, d, n), whatever the point) and the warp-steps' (:func:`_latency`):
on the card the time follows the warp-steps, ``N / states`` threads a
channel, more than the states a step carries, as long as an SM holds
enough warps to hide a step's chain; fewer states a thread mean more
warp-steps, more states fewer warps.  All are spread over the SMs the
CTAs fill.

The shape class keeps a power-of-two bucket of the batch (the JAX package
drops it): the card runs ``batch`` times the CTAs of one sequence, so the
hint's CTA count and traffic cover the whole call, and a B = 8 call does
not recall a B = 1 winner.

``ssm_scan_bwd`` (the backward kernel) is a registry op of its own, with
the forward's class keys (:func:`bwd_shape_class`) and tunables of its own
(:func:`ssm_bwd_region`): ``block_d`` the channels of a CTA, ``chunk``
the steps of a trip (a "sequential" dim, 32 or 64, padded past S),
``seg`` the steps a thread carries and ``channels`` the channels it
carries (a compiled pair of the two), a point surviving where the kernel
takes it (:func:`~.ssm_scan.bwd_refusal`) and its shared memory fits.
Its hint is the largest of the bytes' time, the SFU's (each decay taken
twice, and each segment's product once a sweep) and the time of both
sweeps (:func:`_bwd_latency`): sweep 2's (t, d, n) at a rate fitted to
each compiled tile, faster with more resident warps, over the waves of
CTAs the SMs hold, sweep 1's at one rate, and the dB/dC partials' traffic.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import ssm_scan_bwd_ref, ssm_scan_ref
from .ssm_scan import (
    BWD_TILES, DTYPES, STATES, WARP, bwd_group, bwd_refusal, bwd_scratch_bytes, bwd_smem_bytes,
    bwd_threads, bwd_traffic, group, max_threads, pad_states, sfu_seconds, smem_bytes, ssm_scan,
    ssm_scan_bwd, traffic,
)

_ELT = {str(dt).replace("torch.", ""): elt for dt, elt in DTYPES.items()}
CHUNK_MAX = 256  # longer trips buy nothing once two stages overlap the loads

# One warp's step of its K states, in SM time: the x and dt loads, dt x,
# each state's decay, exp and two FMAs, a share of the group's shuffles and
# store.  Fitted to the sweeps of chip_smoke.py at falcon-mamba-7b width on
# an H100 SXM: the time follows the warp-steps, N / K threads a channel,
# far more than the states (the chain of a step, not the SFU, sets it).
WARP_STEP_S = 9.9e-9
STATE_STEP_S = 3.1e-10
# Resident warps an SM needs to hide a step's chain; below it the
# warp-steps stretch in proportion.
WARPS_FULL = 8


def _elt(bp: Mapping[str, Any]) -> int:
    return _ELT.get(bp.get("dtype", "float32"), 4)


def _threads(bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    return point["block_d"] * pad_states(bp["n_state"]) // point["states"]


def _takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    threads = _threads(bp, point)
    whole_groups = point["chunk"] % group(point["states"]) == 0 or point["chunk"] == bp["seq"]
    lanes = pad_states(bp["n_state"]) // point["states"]  # a channel's, within a warp
    return (threads % WARP == 0 and threads <= max_threads(point["states"]) and whole_groups
            and lanes <= WARP)


def _latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """The warp-steps' time over the SMs the CTAs fill, stretched where an
    SM holds fewer than WARPS_FULL warps, and no less than the SFU's."""
    B, S, D, N = bp["batch"], bp["seq"], bp["d_inner"], pad_states(bp["n_state"])
    k = point["states"]
    ctas = B * (D // point["block_d"])
    sms = min(ctas, arch.sm_count)
    warps = ctas * _threads(bp, point) / WARP / sms  # resident on an SM
    warp_steps = B * S * D * (N // k) / WARP
    steps = warp_steps * (WARP_STEP_S + k * STATE_STEP_S) / sms
    steps /= min(1.0, warps / WARPS_FULL)
    return max(steps, sfu_seconds(B, S, D, N, arch.peak_flops_fp32) * arch.sm_count / sms)


def _dims(bp: Mapping[str, Any]):
    N = pad_states(bp["n_state"])
    widest = max(max_threads(k) * k // N for k in STATES if N % k == 0 and N // k <= WARP)
    return (
        TileDim("block_d", bp["d_inner"], semantic="grid",
                min_tile=max(1, WARP // N), max_tile=widest),
        TileDim("chunk", bp["seq"], semantic="sequential", max_tile=CHUNK_MAX,
                allow_padding=True),
        TileDim("states", N, semantic="sequential", min_tile=1, max_tile=STATES[-1],
                pow2_only=True),
    )


SSM_POLICY = TilePolicy(
    kernel="ssm_scan",
    dims=_dims,
    vmem_model=lambda bp, p: smem_bytes(p["block_d"], p["chunk"], bp["n_state"], _elt(bp)),
    traffic_model=lambda bp, p: traffic(
        bp["batch"], bp["seq"], bp["d_inner"], bp["n_state"], _elt(bp)
    ),
    grid_multiplier=lambda bp: bp["batch"],
    latency_model=_latency,
    point_filter=_takes,
)


def ssm_region(
    d_inner: int, seq_len: int, n_state: int, batch: int = 1,
    arch: Optional[ArchSpec] = None, dtype: str = "float32",
) -> ATRegion:
    arch = arch or local_arch()
    emitted = SSM_POLICY.emit(
        arch,
        {"d_inner": d_inner, "seq": seq_len, "n_state": n_state, "batch": batch,
         "dtype": dtype},
    )

    def instantiate(point: Mapping[str, Any]):
        bd, ck, k = point["block_d"], point["chunk"], point["states"]
        return lambda x, dt, A, Bc, Cc, D: ssm_scan(x, dt, A, Bc, Cc, D,
                                                    block_d=bd, chunk=ck, states=k)

    return ATRegion(
        "ssm_scan_cuda", emitted.space, instantiate, oracle=ssm_scan_ref,
        space_signature=emitted.signature, hints=emitted.hints, arch=arch,
    )


def shape_class(x, dt, A, Bc, Cc, D, kernel: str = "ssm_scan") -> BasicParams:
    """(d_inner, seq, n_state, dtype) fix the candidate family; the batch
    enters as a power-of-two bucket, which sets the CTA count.
    ``framework`` and a ``backend`` of ``cuda``/``cpu`` keep the port's
    keys apart from the JAX package's in a shared file."""
    return BasicParams.make(
        kernel=kernel,
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
    return ssm_region(bp["d_inner"], bp["seq"], bp["n_state"], bp["batch"], arch=arch,
                      dtype=bp["dtype"])


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


# -- the backward kernel ----------------------------------------------------------

# SM time of one (t, d, n) of sweep 2 at 8 resident warps an SM, by (seg,
# channels, time lanes), and its speed-up with resident warps up to 16
# ((8 / warps) ** BWD_WARPS_EXP); sweep 1 (the trips' maps and their
# chaining) a (t, d, n) of the call, whatever the tile.  Fitted to
# chip_smoke.py's sweeps of ssm_scan_bwd at falcon-mamba-7b width, B = 1 and
# 2, on an H100 SXM (the [hint] lines).
BWD_ITEM_S = {(16, 1, 4): 0.278e-9, (8, 2, 4): 0.240e-9, (8, 1, 4): 0.348e-9,
              (8, 1, 8): 0.560e-9, (4, 1, 8): 0.420e-9, (4, 2, 8): 0.355e-9}
BWD_WARPS_EXP = 0.38
SWEEP1_S = 5.4e-13
# Registers a thread of the compiled sweep-2 kernel takes, by (seg,
# channels) (its [ptxas] lines in chip_smoke.py, float32; bf16 within 8)
BWD_REGISTERS = {(4, 1): 128, (8, 1): 162, (16, 1): 244, (4, 2): 161, (8, 2): 226}


def _bwd_takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    return bwd_refusal(bp["d_inner"], point["block_d"], point["chunk"], point["seg"],
                       point["channels"]) is None


def _bwd_resident(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    """Sweep-2 CTAs of the point one SM holds at once: by its shared memory
    (and the 1 KiB a CTA reserves), its threads and its registers."""
    seg, ch = point["seg"], point["channels"]
    threads = bwd_threads(point["block_d"], point["chunk"], seg, ch)
    smem = bwd_smem_bytes(point["block_d"], point["chunk"], bp["n_state"], seg, ch, _elt(bp))
    regs = BWD_REGISTERS.get((seg, ch), 255) * threads
    return max(1, min((arch.smem_per_block + 1024) // (smem + 1024), 2048 // threads,
                      65536 // regs))


def _bwd_latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """Sweep 1's time, sweep 2's (each wave of CTAs an SM holds at once
    runs their (t, d, n) at the tile's rate for the warps they bring), and
    the dB/dC partials written and read again at the memory rate; no less
    than the SFU's two exps a (t, d, n)."""
    B, S, D, N = bp["batch"], bp["seq"], bp["d_inner"], bp["n_state"]
    bd, ck, seg, ch = point["block_d"], point["chunk"], point["seg"], point["channels"]
    ctas = B * (D // bd)
    resident = min(_bwd_resident(arch, bp, point), -(-ctas // arch.sm_count))
    warps = resident * bwd_threads(bd, ck, seg, ch) / WARP
    per_item = (BWD_ITEM_S[(seg, ch, bwd_group(ck, seg))]
                * (8 / min(warps, 16)) ** BWD_WARPS_EXP)
    waves = -(-ctas // (arch.sm_count * resident))
    sweep2 = waves * resident * -(-S // ck) * ck * bd * N * per_item
    partials = 2 * 4.0 * B * (D // bd) * S * N
    steps = SWEEP1_S * B * S * D * N + sweep2 + 2 * partials / arch.hbm_bandwidth
    sfu = (2 + 2 / seg) * sfu_seconds(B, S, D, N, arch.peak_flops_fp32)
    return max(steps, sfu * arch.sm_count / min(ctas, arch.sm_count))


def _bwd_traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the call, the scratch's writes and reads (the
    trip-start states, the CTAs' dB and dC partials) included: ranking
    only."""
    B, S, D, N = bp["batch"], bp["seq"], bp["d_inner"], bp["n_state"]
    flops, bytes_ = bwd_traffic(B, S, D, N, _elt(bp))
    return flops, bytes_ + 2.0 * bwd_scratch_bytes(B, S, D, N, point["block_d"], point["chunk"])


def _bwd_dims(bp: Mapping[str, Any]):
    return (
        TileDim("block_d", bp["d_inner"], semantic="grid", min_tile=8, max_tile=256),
        TileDim("chunk", bp["seq"], semantic="sequential",
                max_tile=max(seg * lanes for seg, _, lanes in BWD_TILES), allow_padding=True,
                pow2_only=True),
        TileDim("seg", 16, semantic="sequential", min_tile=4, max_tile=16, pow2_only=True),
        TileDim("channels", 2, semantic="sequential", min_tile=1, max_tile=2, pow2_only=True),
    )


SSM_BWD_POLICY = TilePolicy(
    kernel="ssm_scan_bwd",
    dims=_bwd_dims,
    vmem_model=lambda bp, p: bwd_smem_bytes(p["block_d"], p["chunk"], bp["n_state"], p["seg"],
                                            p["channels"], _elt(bp)),
    traffic_model=_bwd_traffic,
    grid_multiplier=lambda bp: bp["batch"],
    latency_model=_bwd_latency,
    point_filter=_bwd_takes,
)


def ssm_bwd_region(
    d_inner: int, seq_len: int, n_state: int, batch: int = 1,
    arch: Optional[ArchSpec] = None, dtype: str = "float32",
) -> ATRegion:
    arch = arch or local_arch()
    emitted = SSM_BWD_POLICY.emit(
        arch,
        {"d_inner": d_inner, "seq": seq_len, "n_state": n_state, "batch": batch,
         "dtype": dtype},
    )

    def instantiate(point: Mapping[str, Any]):
        tiles = {k: point[k] for k in ("block_d", "chunk", "seg", "channels")}
        return lambda x, dt, A, Bc, Cc, D, dy, dh=None: ssm_scan_bwd(
            x, dt, A, Bc, Cc, D, dy, dh, **tiles)

    return ATRegion(
        "ssm_scan_bwd_cuda", emitted.space, instantiate, oracle=ssm_scan_bwd_ref,
        space_signature=emitted.signature, hints=emitted.hints, arch=arch,
    )


def bwd_shape_class(x, dt, A, Bc, Cc, D, dy, dh=None) -> BasicParams:
    """The forward's class keys (d_inner, seq, n_state, batch bucket,
    dtype, device)."""
    return shape_class(x, dt, A, Bc, Cc, D, kernel="ssm_scan_bwd")


def _make_bwd_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return ssm_bwd_region(bp["d_inner"], bp["seq"], bp["n_state"], bp["batch"], arch=arch,
                          dtype=bp["dtype"])


register_kernel(
    KernelSpec(
        "ssm_scan_bwd",
        make_region=_make_bwd_region,
        shape_class=bwd_shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
