"""Serving runtime for the port: the static :class:`Server`, the
continuous-batching :class:`StreamingEngine` over a paged KV pool, the
:class:`BackgroundTuner` that keeps tuning off the hot path, and the seeded
:class:`ChaosInjector`.  Training waits for its slice."""
from .background_tuner import BackgroundTuner
from .chaos import ChaosError, ChaosInjector, ChaosStats
from .engine import (
    BlockAllocator,
    EngineStalled,
    KVPoolExhausted,
    PagedKVCache,
    RequestResult,
    StreamStats,
    StreamingEngine,
)
from .serve import Server, ServeStats

__all__ = [
    "Server",
    "ServeStats",
    "BlockAllocator",
    "EngineStalled",
    "KVPoolExhausted",
    "PagedKVCache",
    "RequestResult",
    "StreamStats",
    "StreamingEngine",
    "BackgroundTuner",
    "ChaosError",
    "ChaosInjector",
    "ChaosStats",
]
