"""AT region and KernelSpec for the flash attention kernel.

The emitted space is exactly what the kernel takes: ``block_q`` ladders
from the tensor-core fragment edge (a "lane" dim, one CTA per q block),
``block_kv`` is a "sequential" dim (a loop inside the CTA, adding no CTAs),
both tile past a sequence they do not divide, and a point survives only
if its real shared-memory bytes fit the card's opt-in limit.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .flash_attention import flash_attention, smem_bytes
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
    """(flops, bytes) of one (batch, head) — ranking only.  K and V are
    re-read once per q block; flops count the causal blocks the kernel
    visits, tail padding included."""
    s, hd, elt = bp["seq"], bp["hd"], _ELT.get(bp["dtype"], 4)
    bq, bkv = point["block_q"], point["block_kv"]
    keys = _keys_visited(s, bq, bkv)
    flops = 4.0 * hd * bq * keys
    bytes_ = elt * (2.0 * s * hd + 2.0 * keys * hd)
    return flops, bytes_


FLASH_POLICY = TilePolicy(
    kernel="flash_attention",
    dims=lambda bp: (
        TileDim("block_q", bp["seq"], semantic="lane", allow_padding=True),
        TileDim("block_kv", bp["seq"], semantic="sequential", min_tile=16,
                allow_padding=True),
    ),
    vmem_model=lambda bp, p: smem_bytes(
        p["block_q"], p["block_kv"], bp["hd"], _ELT.get(bp["dtype"], 4)
    ),
    traffic_model=_traffic,
)


def flash_region(
    seq_len: int, head_dim: int, dtype: str = "float32",
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    arch = arch or local_arch()
    emitted = FLASH_POLICY.emit(arch, {"seq": seq_len, "hd": head_dim, "dtype": dtype})

    def instantiate(point: Mapping[str, Any]):
        bq, bkv = point["block_q"], point["block_kv"]
        return lambda q, k, v: flash_attention(q, k, v, block_q=bq, block_kv=bkv)

    return ATRegion(
        "flash_attention_cuda", emitted.space, instantiate,
        oracle=attention_ref, space_signature=emitted.signature,
        hints=emitted.hints, arch=arch,
    )


def shape_class(q, k, v) -> BasicParams:
    """Bucket a call: block candidates depend on (seq, head_dim, dtype), not
    on batch size or head counts, so those are dropped from the DB key.
    ``framework`` and a ``backend`` of ``cuda``/``cpu`` keep the port's keys
    apart from the JAX package's in a shared file."""
    return BasicParams.make(
        kernel="flash_attention",
        seq=int(q.shape[1]),
        hd=int(q.shape[3]),
        dtype=str(q.dtype).replace("torch.", ""),
        backend=q.device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return flash_region(bp["seq"], bp["hd"], bp["dtype"], arch=arch)


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
