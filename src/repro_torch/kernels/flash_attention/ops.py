"""AT region and KernelSpec for the flash attention kernels.

The emitted space is exactly what the kernel of the dtype takes: every
point passes :func:`~.flash_attention.launchable`, the predicate the
wrapper checks, at the call's head dim (run on the least instantiated tile
head dim at or above it; one off the kernels' 16-byte rule as the padded
head dim the wrapper runs it at), and a head dim the wrapper does not
take (past 256) raises the wrapper's error here too.
``block_q`` is a "lane" dim (one CTA per q block), ``block_kv`` a
"sequential" dim (a loop inside the CTA, adding no CTAs); both tile past a
sequence they do not divide, and a point survives only if its real
shared-memory bytes fit the card's opt-in limit.

* bfloat16 (the wgmma kernel): the instantiated tiles and no others,
  powers of two with ``block_q`` from a warpgroup's 64 rows to 128 and
  ``block_kv`` from 32 to 256 (128 at tile hd 128, 64 at 256).  Its
  flops are charged at the bf16 tensor-core rate, and its hint also has a
  latency term: the
  kernel waits on every product, so each warpgroup's KV trip is a chain of
  dependent steps (:data:`TRIP_S` long), which an SM overlaps only across
  the warpgroups it holds at once (CUDA's occupancy of the compiled tile
  on the card; without the card, the bound shared memory and threads
  give).
* float32 (the 3xTF32 ``mma.sync`` kernel): the instantiated tiles and no
  others, ``block_q`` 64 or 128 (16 rows a warp), ``block_kv`` from 32 to
  128 (64 at tile hd 128; (64, 32) alone at 256).  Each multiply-add is
  three TF32 products, so its flops are charged at a third of the TF32
  tensor-core rate.

The shape class keeps a power-of-two bucket of B·H (the JAX package drops
it): the card runs one CTA per (q block, head, batch), so the hint's CTA
count and traffic cover the whole call, and a call with many heads does
not recall the winner of one with few.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .flash_attention import (
    F32_BLOCK_KV, F32_BLOCK_Q, SM90_BLOCK_KV, SM90_BLOCK_Q, ctas_per_sm, f32_max_block_kv,
    f32_max_block_q, flash_attention, head_dim_error, launchable, padded_hd,
    sm90_max_block_kv, smem_bytes, tile_hd,
)
from .ref import attention_ref

_ELT = {"float32": 4, "bfloat16": 2}


def _keys_visited(seq: int, bq: int, bkv: int) -> int:
    """Keys each q block walks in the causal kernel, summed over q blocks."""
    total = 0
    for q0 in range(0, seq, bq):
        end = min(seq, q0 + bq)
        total += -(-end // bkv) * bkv
    return total


def _traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the whole call, all ``heads`` (batch × query
    heads) — ranking only.  Flops count the causal blocks the kernel
    visits, tail padding included.  Bytes count q and o once, and K and V
    once per query head: the CTAs of one head run together (q blocks are
    the grid's fastest axis), so later q blocks re-read its K and V from
    the L2, not device memory."""
    s, hd, elt = bp["seq"], bp["hd"], _ELT.get(bp["dtype"], 4)
    bq, bkv = point["block_q"], point["block_kv"]
    flops = 4.0 * hd * bq * _keys_visited(s, bq, bkv)
    bytes_ = elt * (2.0 * s * hd + 2.0 * s * hd)
    return bp["heads"] * flops, bp["heads"] * bytes_


# One warpgroup's KV trip in the bf16 kernel (wait for the tile, S = Q.K^T
# and its wait, the softmax, O += P.V and its wait, the block barrier): the
# sweeps of chip_smoke.py at tinyllama and qwen3-0.6b widths on an H100 SXM
# imply 1.9-4.9 us a trip across the tiles, 2.7 us at the median.
TRIP_S = 2.8e-6


def _warpgroup_trips(seq: int, bq: int, bkv: int):
    """(KV trips of all warpgroups, trips of the longest CTA) for one head:
    a warpgroup skips the blocks wholly above its 64 rows' diagonal."""
    total = longest = 0
    for q0 in range(0, seq, bq):
        nkv = -(-min(seq, q0 + bq) // bkv)
        longest = max(longest, nkv)
        for row0 in range(q0, q0 + bq, 64):
            total += min(nkv, (row0 + 63) // bkv + 1)
    return total, longest


def _ctas_per_sm(arch: ArchSpec, hd: int, bq: int, bkv: int) -> int:
    if arch.backend == "cuda" and torch.cuda.is_available():
        return ctas_per_sm(hd, bq, bkv)
    # without the card: the bound the SM's 228 KiB of shared memory (1 KiB
    # reserved a CTA) and its 2048 threads give; registers, which the
    # compiled tile alone knows, may bind first
    smem = smem_bytes(bq, bkv, hd, 2)
    return max(1, min((arch.smem_per_block + 1024) // (smem + 1024), 2048 // (2 * bq)))


def _latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """Least time of the bf16 kernel's dependent chains: all warpgroups'
    trips spread over the warpgroups the SMs hold at once, and no less than
    the longest CTA's trips."""
    if bp["dtype"] != "bfloat16":
        return 0.0
    bq, bkv = point["block_q"], point["block_kv"]
    total, longest = _warpgroup_trips(bp["seq"], bq, bkv)
    resident = _ctas_per_sm(arch, bp["hd"], bq, bkv) * (bq // 64)
    return TRIP_S * max(bp["heads"] * total / (arch.sm_count * resident), longest)


def _dims(bp: Mapping[str, Any]):
    why = head_dim_error(bp["hd"], bp["dtype"])
    if why is not None:
        raise ValueError(why)
    tile = tile_hd(bp["hd"], bp["dtype"])
    if bp["dtype"] == "bfloat16":
        block_q, block_kv = SM90_BLOCK_Q, SM90_BLOCK_KV
        max_q, max_kv = block_q[-1], sm90_max_block_kv(tile)
    else:
        block_q, block_kv = F32_BLOCK_Q, F32_BLOCK_KV
        max_q, max_kv = f32_max_block_q(tile), f32_max_block_kv(tile)
    return (
        TileDim("block_q", bp["seq"], semantic="lane", min_tile=block_q[0],
                max_tile=max_q, allow_padding=True, pow2_only=True),
        TileDim("block_kv", bp["seq"], semantic="sequential", min_tile=block_kv[0],
                max_tile=max_kv, allow_padding=True, pow2_only=True),
    )


FLASH_POLICY = TilePolicy(
    kernel="flash_attention",
    dims=_dims,
    vmem_model=lambda bp, p: smem_bytes(
        p["block_q"], p["block_kv"], bp["hd"], _ELT.get(bp["dtype"], 4)
    ),
    traffic_model=_traffic,
    grid_multiplier=lambda bp: bp["heads"],
    # 3xTF32: three TF32 products for every float32 multiply-add
    flop_rate=lambda arch, bp: (
        arch.peak_flops if bp["dtype"] == "bfloat16" else arch.peak_flops_tf32 / 3
    ),
    latency_model=_latency,
    point_filter=lambda bp, p: launchable(bp["hd"], bp["dtype"], p["block_q"], p["block_kv"]),
)


def flash_region(
    seq_len: int, head_dim: int, dtype: str = "float32",
    arch: Optional[ArchSpec] = None, heads: int = 1,
) -> ATRegion:
    """``heads`` is batch × query heads (its bucket, from the shape class).
    A head dim off the kernels' rule runs padded (:func:`padded_hd`), so it
    is offered the padded head dim's points, hints and signature."""
    arch = arch or local_arch()
    why = head_dim_error(head_dim, dtype)
    if why is not None:
        raise ValueError(why)
    emitted = FLASH_POLICY.emit(
        arch, {"seq": seq_len, "hd": padded_hd(head_dim, dtype), "dtype": dtype,
               "heads": heads}
    )

    def instantiate(point: Mapping[str, Any]):
        bq, bkv = point["block_q"], point["block_kv"]
        return lambda q, k, v: flash_attention(q, k, v, block_q=bq, block_kv=bkv)

    return ATRegion(
        "flash_attention_cuda", emitted.space, instantiate,
        oracle=attention_ref, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def shape_class(q, k, v) -> BasicParams:
    """(seq, head_dim, dtype) fix the candidate family; B·H enters as a
    power-of-two bucket, which sets the CTA count.  ``framework`` and a
    ``backend`` of ``cuda``/``cpu`` keep the port's keys apart from the JAX
    package's in a shared file."""
    return BasicParams.make(
        kernel="flash_attention",
        seq=int(q.shape[1]),
        hd=int(q.shape[3]),
        heads=bucket_pow2(int(q.shape[0]) * int(q.shape[2])),
        dtype=str(q.dtype).replace("torch.", ""),
        backend=q.device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return flash_region(bp["seq"], bp["hd"], bp["dtype"], arch=arch, heads=bp["heads"])


register_kernel(
    KernelSpec(
        "flash_attention",
        make_region=_make_region,
        shape_class=shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
