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

``flash_attention_bwd`` (the backward kernels) is a registry op of its
own: the same shape class with the query heads a KV head (``group``), the
instantiated (block_q, block_kv) tiles its
:func:`~.flash_attention.bwd_launchable` takes (the wgmma kernel, bf16: 64
or 128 each, block_q 64 at hd 128, (64, 64) alone at hd 256; the
float32 ``mma.sync`` kernel: 32 or 64, block_kv 32 at hd 256) and, in
either kernel where the group has more than one head, ``kv_split`` (a
"pieces" dim: every divisor of ``group``, each group's dk/dv sum spread
over that many CTAs).
Its hint: seven causal products (S and dP recomputed in each of its two
passes, then dS.K, P^T.dO and dS^T.Q) at the dtype's rate, the bytes of
the inputs, the gradients and ``kv_split``'s float32 partials, and a
latency term for each pass's longest CTA (the dk/dv pass's first key block
walks ``group / kv_split`` heads of every q block), which is what the split
shortens.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ...core import ATRegion, BasicParams, KernelSpec, bucket_pow2, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .flash_attention import (
    F32_BLOCK_KV, F32_BLOCK_Q, SM90_BLOCK_KV, SM90_BLOCK_Q, bwd_blocks, bwd_ctas_per_sm,
    bwd_launchable, bwd_scratch_bytes, bwd_sm90, bwd_smem_bytes, ctas_per_sm, f32_max_block_kv,
    f32_max_block_q, flash_attention, flash_attention_bwd, head_dim_error, launchable,
    padded_hd, sm90_max_block_kv, smem_bytes, tile_hd,
)
from .ref import attention_bwd_plain, attention_ref

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


# -- the backward kernel ----------------------------------------------------------


def _bwd_traffic(bp: Mapping[str, Any], point: Mapping[str, Any]):
    """(flops, bytes) of the whole backward call — ranking only.  Flops:
    seven products over the causal (row, key) pairs the dq pass visits,
    tails included; bytes: q, o, do and dq once per query head, k, v, dk
    and dv once per KV head, and at a ``kv_split`` above 1 its dk and dv
    partials (float32) written once and read once by the reduce pass."""
    s, hd, elt = bp["seq"], bp["hd"], _ELT.get(bp["dtype"], 4)
    bq, bkv = point["block_q"], point["block_kv"]
    flops = 7 * 2.0 * hd * bq * _keys_visited(s, bq, bkv)
    bytes_ = elt * s * hd * (4.0 + 4.0 / bp["group"])
    bytes_ += 2.0 * bwd_scratch_bytes(1, s, 1, hd, point.get("kv_split", 1)) / bp["group"]
    return bp["heads"] * flops, bp["heads"] * bytes_


# One warpgroup's trip of 64 streamed rows in either pass of the wgmma
# backward (wait for the tile, the two scoring products and their wait, P
# and dS in registers, the two (dk/dv) or one (dq) accumulating products and
# their wait, the block barrier); a trip of n rows takes (1 + n/64)/2 of it
# (the waits and the barrier do not grow with n).  With it, chip_smoke.py's
# bf16 backward sweeps on an H100 SXM measure 0.85-1.37 of the estimate (the
# median over a shape's points), and the staged prescreen's survivors hold
# the fastest point at every swept shape.  That fit is at tile hd 64 and
# 128; past 128 a trip's products grow with hd (K of the scoring products,
# N of the accumulating ones), so its time is taken in proportion.
BWD_TRIP_S = 1.7e-6


def _trip_s(rows: int, hd: int) -> float:
    return BWD_TRIP_S * (1 + rows / 64) / 2 * max(1.0, hd / 128)


def _dkv_trips(seq: int, bq: int, bkv: int):
    """(warpgroup trips of the dk/dv pass over one query head's q blocks,
    summed over its key blocks; q blocks the longest CTA walks for one
    head): a CTA's keys walk the q blocks from the one holding its first
    key; a warpgroup skips a block wholly above its 64 keys."""
    nq = -(-seq // bq)
    total = 0
    for k0 in range(0, seq, bkv):
        for w0 in range(k0, k0 + bkv, 64):
            total += sum(1 for i in range(k0 // bq, nq) if i * bq + bq - 1 >= w0)
    return total, nq


# One CTA trip of the float32 mma.sync backward (the trip's scores, the
# staged P and dS, the accumulating products, three barriers) takes
# BWD_F32_TRIP_S x (0.1 + block_q x block_kv x tile hd / (64 x 32 x 256));
# a pass takes its CTA trips spread over the SMs plus 0.9 of its longest
# CTA's (the tail a causal walk leaves; one CTA of 8 warps keeps an SM's
# tensor cores busy, so a second resident CTA is not counted).  Fitted to
# the float32 backward's sweeps on an H100 SXM at chip_smoke.py's shapes
# (tinyllama, qwen3-0.6b, hd 36, recurrentgemma-2b's hd 256; every
# kv_split): the estimate within 0.77-1.18 of the measured time, and the
# staged prescreen's survivors hold the fastest point at each shape.
BWD_F32_TRIP_S = 8.45e-6
BWD_F32_TAIL = 0.9


def _bwd_resident(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any],
                  which: str) -> int:
    """Warpgroups of the wgmma backward's pass ``which`` one SM holds at
    once: CUDA's occupancy of the compiled tile on the card; without the
    card, the bound the shared memory and threads give (registers, which the
    compiled tile alone knows, may bind first)."""
    bq, bkv = point["block_q"], point["block_kv"]
    groups = (bq if which == "dq" else bkv) // 64
    if arch.backend == "cuda" and torch.cuda.is_available():
        return bwd_ctas_per_sm(bp["hd"], bq, bkv, which) * groups
    smem = bwd_smem_bytes(bq, bkv, bp["hd"], 2)
    return groups * max(1, min((arch.smem_per_block + 1024) // (smem + 1024),
                               2048 // (128 * groups)))


def _bwd_latency(arch: ArchSpec, bp: Mapping[str, Any], point: Mapping[str, Any]) -> float:
    """Least time of the backward's dependent chains, its two passes one
    after the other.  wgmma (bf16): each pass's warpgroup trips spread over
    the warpgroups the SMs hold at once, and no less than its longest CTA's
    trips (the dk/dv pass's walks ``group / kv_split`` heads).  mma.sync
    (float32): each pass's CTA trips spread over the SMs plus a share of
    its longest CTA's."""
    tile = tile_hd(bp["hd"], bp["dtype"])
    bq, bkv = point["block_q"], point["block_kv"]
    heads, group, split = bp["heads"], bp["group"], point.get("kv_split", 1)
    dq_total, dq_longest = _warpgroup_trips(bp["seq"], bq, bkv)
    kv_total, kv_longest = _dkv_trips(bp["seq"], bq, bkv)
    sms = arch.sm_count
    if not bwd_sm90(bp["dtype"]):
        trip = BWD_F32_TRIP_S * (0.1 + bq * bkv * tile / (64 * 32 * 256))
        return trip * (heads * (dq_total + kv_total) / sms
                       + BWD_F32_TAIL * (dq_longest + kv_longest * group // split))
    dq = max(heads * dq_total / (sms * _bwd_resident(arch, bp, point, "dq")), dq_longest)
    dkv = max(heads * kv_total / (sms * _bwd_resident(arch, bp, point, "dkv")),
              kv_longest * group // split)
    return _trip_s(bkv, tile) * dq + _trip_s(bq, tile) * dkv


def _bwd_dims(bp: Mapping[str, Any]):
    why = head_dim_error(bp["hd"], bp["dtype"])
    if why is not None:
        raise ValueError(why)
    tile = tile_hd(bp["hd"], bp["dtype"])
    block_q, block_kv = bwd_blocks(tile, bp["dtype"])
    dims = [
        TileDim("block_q", bp["seq"], semantic="lane", min_tile=block_q[0],
                max_tile=block_q[-1], allow_padding=True, pow2_only=True),
        TileDim("block_kv", bp["seq"], semantic="sequential", min_tile=block_kv[0],
                max_tile=block_kv[-1], allow_padding=True, pow2_only=True),
    ]
    if bp["group"] > 1:
        dims.append(TileDim("kv_split", bp["group"], semantic="pieces", min_tile=1,
                            max_tile=bp["group"], divisors=True))
    return tuple(dims)


FLASH_BWD_POLICY = TilePolicy(
    kernel="flash_attention_bwd",
    dims=_bwd_dims,
    vmem_model=lambda bp, p: bwd_smem_bytes(
        p["block_q"], p["block_kv"], bp["hd"], _ELT.get(bp["dtype"], 4)
    ),
    traffic_model=_bwd_traffic,
    grid_multiplier=lambda bp: bp["heads"],
    flop_rate=lambda arch, bp: (
        arch.peak_flops if bp["dtype"] == "bfloat16" else arch.peak_flops_tf32 / 3
    ),
    latency_model=_bwd_latency,
    point_filter=lambda bp, p: bwd_launchable(bp["hd"], bp["dtype"], p["block_q"],
                                              p["block_kv"], p.get("kv_split", 1),
                                              bp["group"]),
)


def flash_bwd_region(
    seq_len: int, head_dim: int, dtype: str = "float32",
    arch: Optional[ArchSpec] = None, heads: int = 1, group: int = 1,
) -> ATRegion:
    """The backward's region: ``heads`` is the B·H bucket, ``group`` the
    query heads a KV head; a head dim off the kernels' rule is offered the
    padded head dim's points, as the forward's region is."""
    arch = arch or local_arch()
    why = head_dim_error(head_dim, dtype)
    if why is not None:
        raise ValueError(why)
    emitted = FLASH_BWD_POLICY.emit(
        arch, {"seq": seq_len, "hd": padded_hd(head_dim, dtype), "dtype": dtype,
               "heads": heads, "group": group}
    )

    def instantiate(point: Mapping[str, Any]):
        bq, bkv, split = point["block_q"], point["block_kv"], point.get("kv_split", 1)
        return lambda q, k, v, o, lse, do: flash_attention_bwd(
            q, k, v, o, lse, do, block_q=bq, block_kv=bkv, kv_split=split)

    return ATRegion(
        "flash_attention_bwd_cuda", emitted.space, instantiate,
        oracle=attention_bwd_plain, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def bwd_shape_class(q, k, v, o, lse, do) -> BasicParams:
    """The forward's class keys (seq, head_dim, B·H bucket, dtype, device)
    and the query heads a KV head."""
    return BasicParams.make(
        kernel="flash_attention_bwd",
        seq=int(q.shape[1]),
        hd=int(q.shape[3]),
        heads=bucket_pow2(int(q.shape[0]) * int(q.shape[2])),
        group=int(q.shape[2]) // int(k.shape[2]),
        dtype=str(q.dtype).replace("torch.", ""),
        backend=q.device.type,
        framework="torch",
    )


def _make_bwd_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return flash_bwd_region(bp["seq"], bp["hd"], bp["dtype"], arch=arch, heads=bp["heads"],
                            group=bp["group"])


register_kernel(
    KernelSpec(
        "flash_attention_bwd",
        make_region=_make_bwd_region,
        shape_class=bwd_shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
