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
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import ssm_scan_ref
from .ssm_scan import (
    DTYPES, STATES, WARP, group, max_threads, pad_states, sfu_seconds, smem_bytes, ssm_scan,
    traffic,
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


def shape_class(x, dt, A, Bc, Cc, D) -> BasicParams:
    """(d_inner, seq, n_state, dtype) fix the candidate family; the batch
    enters as a power-of-two bucket, which sets the CTA count.
    ``framework`` and a ``backend`` of ``cuda``/``cpu`` keep the port's
    keys apart from the JAX package's in a shared file."""
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
