"""repro_torch.core — FIBER-layered autotuning for PyTorch on the card.

The registry loop of the JAX package, ported: shape class → TuningDB lookup
→ a candidate space emitted from the card's :class:`ArchSpec` → staged
search (hint prescreen, then finals timed on the device) → ``record_best``
→ zero-evaluation recall through the dispatch fast path::

    from repro_torch.core import autotuned
    out = autotuned("flash_attention")(q, k, v)

The paper's own loop nests (:mod:`.exchange`: the Exchange × LoopFusion
variants as launch shapes; :mod:`.degree`: the ``omp_set_num_threads``
protocol) drive the GKV and Seism3D apps (``repro_torch.apps``);
:mod:`.program` tunes a composition of ops jointly (the serve step's
prefill × decode degrees, ``repro_torch.runtime.Server.joint_tune``).
"""
from .arch import ArchSpec, detect, local_arch
from .autotuned import AutotunedOp, OpState
from .cost import AdaptiveWallClockCost, CostFunction, WallClockCost
from .db import TuningDB
from .degree import DegreeController
from .emit import (
    EmitPolicy,
    EmittedSpace,
    TileDim,
    TilePolicy,
    hint_prescreen,
    pow2_ladder,
    space_signature,
)
from .exchange import (
    GKV_FIGURE_OF_VARIANT,
    ExchangeVariant,
    LaunchShape,
    LoopNest,
    enumerate_exchange_variants,
    launch_shape,
)
from .params import (
    BasicParams,
    EmptySpace,
    ParamSpace,
    PerfParam,
    pp_key,
    project_point,
)
from .program import JointSearch, ProgramMember, ProgramResult, ProgramSpec
from .region import ATRegion
from .registry import (
    REGISTRY,
    KernelSpec,
    Registry,
    autotuned,
    get_kernel,
    kernel_names,
    register_kernel,
)
from .search import (
    CoordinateDescent,
    ExhaustiveSearch,
    SearchResult,
    StagedSearch,
    SuccessiveHalving,
    Trial,
    default_prescreen_k,
)
from .traffic import PHASES, TrafficClass, bucket_pow2
from .tuner import RuntimeSelector, Tuner

__all__ = [
    "AutotunedOp",
    "OpState",
    "KernelSpec",
    "Registry",
    "REGISTRY",
    "autotuned",
    "get_kernel",
    "kernel_names",
    "register_kernel",
    "BasicParams",
    "EmptySpace",
    "ParamSpace",
    "PerfParam",
    "pp_key",
    "project_point",
    "ATRegion",
    "JointSearch",
    "ProgramMember",
    "ProgramResult",
    "ProgramSpec",
    "DegreeController",
    "ExchangeVariant",
    "GKV_FIGURE_OF_VARIANT",
    "LaunchShape",
    "LoopNest",
    "enumerate_exchange_variants",
    "launch_shape",
    "ArchSpec",
    "detect",
    "local_arch",
    "EmitPolicy",
    "EmittedSpace",
    "TileDim",
    "TilePolicy",
    "hint_prescreen",
    "pow2_ladder",
    "space_signature",
    "TrafficClass",
    "PHASES",
    "bucket_pow2",
    "Tuner",
    "RuntimeSelector",
    "TuningDB",
    "CostFunction",
    "WallClockCost",
    "AdaptiveWallClockCost",
    "ExhaustiveSearch",
    "CoordinateDescent",
    "SuccessiveHalving",
    "StagedSearch",
    "default_prescreen_k",
    "SearchResult",
    "Trial",
]
