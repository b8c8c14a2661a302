"""Runtime for the port: the fault-tolerant :class:`Trainer` (AdamW,
checkpoint/restart, joint microbatch × remat tuning); the static
:class:`Server`, the continuous-batching :class:`StreamingEngine` over a
paged KV pool, the :class:`BackgroundTuner` that keeps tuning off the hot
path, and the seeded :class:`ChaosInjector`."""
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
from .train import SimulatedFailure, Trainer, TrainLoopConfig

__all__ = [
    "SimulatedFailure",
    "Trainer",
    "TrainLoopConfig",
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
