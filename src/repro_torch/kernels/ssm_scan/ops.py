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
the forward's class keys (:func:`bwd_shape_class`) and tunables
(:func:`ssm_bwd_region`): ``block_d`` and ``states`` as in the forward,
``chunk`` the steps between two saved states, a multiple of the
backward's groups of ``16 / states`` steps (or the whole sequence).  Its
hint is the largest of the bytes' time, the SFU's (each exp is taken
three times: two forward passes to recompute the states, one in the
group walked backward) and the warp-steps' chain, which also pays each
step's shuffles: the sums over a channel's lanes (dx, ddt) and over a
warp's channels (dB_t, dC_t), and a barrier a chunk.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import ssm_scan_bwd_ref, ssm_scan_ref
from .ssm_scan import (
    BWD_MAX_THREADS, DTYPES, STATES, WARP, bwd_group, bwd_scratch_bytes, bwd_smem_bytes, bwd_traffic, group,
    max_threads, pad_states, sfu_seconds, smem_bytes, ssm_scan, ssm_scan_bwd, traffic,
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


def _dims(bp: Mapping[str, Any], threads_limit=max_threads):
    N = pad_states(bp["n_state"])
    widest = max(threads_limit(k) * k // N for k in STATES if N % k == 0 and N // k <= WARP)
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

# One warp-step of the backward, in SM time, where an SM holds
# BWD_WARPS_FULL warps or more: the step run forward twice (the group
# starts, then the group again) and walked backward (BWD_WARP_STEP_S and
# BWD_STATE_STEP_S a state), and its shuffles (SHFL_S each).  Fitted to
# chip_smoke.py's sweeps of ssm_scan_bwd at falcon-mamba-7b width, B = 1
# and 2, on an H100 SXM (the [hint] lines): a point that fits few CTAs an
# SM, by shared memory or registers, stretches in proportion, which is what
# sets the long chunks and the many states a thread apart.
BWD_WARP_STEP_S = 1.8e-8
BWD_STATE_STEP_S = 0.6e-8
SHFL_S = 1.0e-9
BWD_WARPS_FULL = 8
CHUNK_S = 1.0e-6  # a chunk's barriers and the CTA's sums of dB_t, dC_t
# Registers a thread of the compiled backward takes, by states (its [ptxas]
# lines in chip_smoke.py, float32; bf16 within 8 of them)
BWD_REGISTERS = {1: 158, 2: 128, 4: 128, 8: 136, 16: 152}


def _bwd_threads(bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    return point["block_d"] * pad_states(bp["n_state"]) // point["states"]


def _bwd_takes(bp: Mapping[str, Any], point: Mapping[str, Any]) -> bool:
    threads = _bwd_threads(bp, point)
    k = point["states"]
    whole = point["chunk"] % bwd_group(k) == 0 or point["chunk"] == bp["seq"]
    lanes = pad_states(bp["n_state"]) // k
    return threads % WARP == 0 and threads <= BWD_MAX_THREADS and whole and lanes <= WARP


def _bwd_shuffles(n_state: int, states: int) -> int:
    """Shuffles of one warp-step: a butterfly of two sums over a channel's
    lanes, and the reduce-scatter of 2 ``states`` sums over the warp's
    channels (half of what a lane holds a level, one once it holds one)."""
    lanes = pad_states(n_state) // states
    count, held = 2 * (lanes.bit_length() - 1), 2 * states
    for _ in range((WARP // lanes).bit_length() - 1):
        count += max(1, held // 2)
        held = max(1, held // 2)
    return count


def _bwd_resident(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> int:
    """CTAs of the point one SM holds at once: by its shared memory (and
    the 1 KiB a CTA reserves), its threads and its registers."""
    threads = _bwd_threads(bp, point)
    smem = bwd_smem_bytes(point["block_d"], point["chunk"], bp["n_state"], point["states"],
                          _elt(bp))
    regs = BWD_REGISTERS.get(point["states"], 255) * threads
    return max(1, min((arch.smem_per_block + 1024) // (smem + 1024), 2048 // threads,
                      65536 // regs))


def _bwd_latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """The warp-steps' time over the SMs the CTAs fill, stretched where an
    SM holds fewer than BWD_WARPS_FULL warps (its resident CTAs:
    :func:`_bwd_resident`), and no less than the SFU's three exps a
    (t, d, n)."""
    B, S, D, N = bp["batch"], bp["seq"], bp["d_inner"], pad_states(bp["n_state"])
    k = point["states"]
    ctas = B * (D // point["block_d"])
    sms = min(ctas, arch.sm_count)
    warps = min(ctas / sms, _bwd_resident(arch, bp, point)) * _bwd_threads(bp, point) / WARP
    warp_steps = B * S * D * (N // k) / WARP
    per = (BWD_WARP_STEP_S + k * BWD_STATE_STEP_S
           + _bwd_shuffles(bp["n_state"], k) * SHFL_S)
    steps = warp_steps * per / sms
    steps /= min(1.0, warps / BWD_WARPS_FULL)
    steps += ctas / sms * -(-S // point["chunk"]) * CHUNK_S
    return max(steps, 3 * sfu_seconds(B, S, D, N, arch.peak_flops_fp32) * arch.sm_count / sms)


def _bwd_traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the call, the scratch's writes and reads (the
    chunk-start states, the CTAs' dB and dC partials) included: ranking
    only."""
    B, S, D, N = bp["batch"], bp["seq"], bp["d_inner"], bp["n_state"]
    flops, bytes_ = bwd_traffic(B, S, D, N, _elt(bp))
    return flops, bytes_ + 2.0 * bwd_scratch_bytes(B, S, D, N, point["block_d"], point["chunk"])


SSM_BWD_POLICY = TilePolicy(
    kernel="ssm_scan_bwd",
    dims=lambda bp: _dims(bp, lambda k: BWD_MAX_THREADS),
    vmem_model=lambda bp, p: bwd_smem_bytes(p["block_d"], p["chunk"], bp["n_state"],
                                            p["states"], _elt(bp)),
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
        bd, ck, k = point["block_d"], point["chunk"], point["states"]
        return lambda x, dt, A, Bc, Cc, D, dy, dh=None: ssm_scan_bwd(
            x, dt, A, Bc, Cc, D, dy, dh, block_d=bd, chunk=ck, states=k)

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
