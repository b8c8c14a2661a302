"""The ``Exchange`` + ``LoopFusion`` candidate generator (paper §III), on the card.

ppOpen-AT's model: an N-deep perfect loop nest whose body is an elementwise
"calculation kernel".  Two composable transforms produce the candidate
family:

* **LoopFusion (collapse)** — merge the innermost ``N-m+1`` dims into one
  loop, leaving an ``m``-deep nest (m = 1..N).
* **Exchange (directive position)** — place the parallel directive on loop
  ``j`` of the transformed nest (j = 1..m).

This yields ``N(N+1)/2`` variants — exactly the paper's 10 for the GKV
quadruple loop (Figs 1–10).

GPU realization of one variant ``(m, j)`` with parallelism degree ``d``
(the ``omp_set_num_threads`` analogue — :mod:`repro_torch.core.degree`) is
a *launch shape* (:func:`launch_shape`):

* each iteration of the loops **above** the directive is one kernel launch,
  in order, as in OpenMP each outer iteration forks and joins a parallel
  region;
* the **directive loop** (length P) is split over ``min(d, P)`` CTAs of
  ``ceil(P/d)`` iterations each — OpenMP's static schedule, one CTA a
  thread; a CTA walks its iterations in order;
* the loops **below** the directive are collapsed onto the CTA's threads.

One hand-written kernel a body (``csrc/loop_nest.cu``) takes the launch
shape at run time and makes the outer launches in its own loop, so the
variant's loop structure — launches, CTAs, grain — is what a timing
measures.  On CPU tensors the same variant runs the plain version with the
JAX package's semantics (:func:`run_plain`): the directive loop cut into
chunks, the last one edge-padded, the pad sliced off again.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from .cost import _leaves
from .params import ParamSpace, PerfParam
from .region import ATRegion


@dataclass(frozen=True)
class ExchangeVariant:
    """One candidate loop structure: m loops after collapse, directive on j."""

    m: int  # loop count of transformed nest (innermost N-m+1 dims collapsed)
    j: int  # 1-based directive depth in the transformed nest, 1 <= j <= m

    def __post_init__(self) -> None:
        if not (1 <= self.j <= self.m):
            raise ValueError(f"invalid variant (m={self.m}, j={self.j})")

    def label(self, dim_names: Sequence[str]) -> str:
        n = len(dim_names)
        loops = [str(d) for d in dim_names[: self.m - 1]]
        collapsed = "_".join(str(d) for d in dim_names[self.m - 1 :])
        loops.append(collapsed)
        marked = [f"OMP[{l}]" if i + 1 == self.j else l for i, l in enumerate(loops)]
        return ">".join(marked)


def enumerate_exchange_variants(ndims: int) -> List[ExchangeVariant]:
    """All (collapse-depth × directive-position) candidates — N(N+1)/2 of them.

    Ordered to match the paper's figures for N=4:
    (4,2)=Fig1 original, (3,2)=Fig2, (2,2)=Fig3, (4,1)=Fig4, (3,1)=Fig5,
    (2,1)=Fig6, (1,1)=Fig7, (4,3)=Fig8, (3,3)=Fig9, (4,4)=Fig10.
    """
    variants = []
    for m in range(ndims, 0, -1):
        for j in range(1, m + 1):
            variants.append(ExchangeVariant(m=m, j=j))
    return variants


# The paper's figure numbering for the GKV quadruple loop (N=4).
GKV_FIGURE_OF_VARIANT: Dict[Tuple[int, int], str] = {
    (4, 2): "Fig1:original",
    (3, 2): "Fig2:xy-collapse",
    (2, 2): "Fig3:zxy-collapse",
    (4, 1): "Fig4:omp@outermost",
    (3, 1): "Fig5:omp@outermost+xy",
    (2, 1): "Fig6:omp@outermost+zxy",
    (1, 1): "Fig7:vzxy-collapse",
    (4, 3): "Fig8:omp@depth3",
    (3, 3): "Fig9:omp@mx_my",
    (4, 4): "Fig10:omp@innermost",
}


def _prod(xs: Sequence[int]) -> int:
    return reduce(lambda a, b: a * b, xs, 1)


class LaunchShape(NamedTuple):
    """How one (variant, degree) runs on the card."""

    launches: int  # iterations of the loops above the directive, one launch each
    ctas: int      # min(degree, par_len): the directive loop's "threads"
    chunk: int     # ceil(par_len / ctas) directive iterations a CTA
    inner: int     # the loops below the directive, collapsed onto a CTA's threads
    par_len: int   # P, the directive loop's length


def launch_shape(lengths: Sequence[int], variant: ExchangeVariant, degree: int) -> LaunchShape:
    """The launch shape of ``variant`` at ``degree`` over a nest of
    ``lengths`` (the arithmetic of the JAX package's ``variant_fn``)."""
    n = len(lengths)
    if variant.m > n:
        raise ValueError(f"variant {variant} exceeds nest depth {n}")
    if degree < 1:
        raise ValueError(f"degree {degree} must be >= 1")
    jj = variant.j - 1  # 0-based directive loop index in the transformed nest
    if jj < variant.m - 1:  # directive on an uncollapsed dim
        outer, par_len, inner = lengths[:jj], lengths[jj], _prod(lengths[jj + 1:])
    else:                   # directive on the collapsed innermost group
        outer, par_len, inner = lengths[: variant.m - 1], _prod(lengths[variant.m - 1:]), 1
    ctas = max(1, min(int(degree), par_len))  # threads beyond P idle
    return LaunchShape(_prod(outer), ctas, -(-par_len // ctas), inner, par_len)


def _map(fn: Callable[[torch.Tensor], torch.Tensor], x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Mapping):
        return {k: _map(fn, v) for k, v in x.items()}
    return type(x)(_map(fn, v) for v in x)


def run_plain(body: Callable[[Any], Any], inputs: Any, shape: LaunchShape) -> Any:
    """One variant as the JAX package runs it: the directive loop cut into
    ``ctas`` chunks of ``chunk`` iterations, the last one edge-padded, the
    body on the blocks, the pad sliced off.  The body is elementwise, so it
    takes every block at once (the JAX package maps it over the blocks)."""
    o_len, nchunks, chunk, inner, par_len = shape
    padded = nchunks * chunk
    full = next(_leaves(inputs)).shape

    def to_blocks(x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(o_len, par_len, inner)
        if padded > par_len:
            edge = x[:, -1:].expand(o_len, padded - par_len, inner)
            x = torch.cat([x, edge], dim=1)
        return x.reshape(o_len * nchunks, chunk, inner)

    def from_blocks(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(o_len, padded, inner)[:, :par_len].reshape(full)

    return _map(from_blocks, body(_map(to_blocks, inputs)))


class LoopNest:
    """An N-deep elementwise loop nest bracketed as an AT region.

    ``body`` is the plain, shape-polymorphic, elementwise function
    ``body(inputs_block) -> output_block``; ``kernel(inputs, shape)``, where
    given, runs one :class:`LaunchShape` (the kernel on CUDA tensors, the
    plain version on CPU tensors: ``kernels/loop_nest``).  ``inputs`` are a
    dict of tensors all shaped exactly ``lengths`` (pre-broadcast by the
    caller, as the JAX package's are).
    """

    def __init__(
        self,
        name: str,
        dims: Sequence[Tuple[str, int]],
        body: Callable[[Any], Any],
        kernel: Optional[Callable[[Any, LaunchShape], Any]] = None,
    ) -> None:
        if not dims:
            raise ValueError("LoopNest needs at least one dim")
        self.name = name
        self.dim_names = tuple(d[0] for d in dims)
        self.lengths = tuple(int(d[1]) for d in dims)
        self.body = body
        self.kernel = kernel

    # -- oracle ---------------------------------------------------------------

    def reference(self, inputs: Any) -> Any:
        """Whole-domain single-shot evaluation — the plain oracle."""
        return self.body(inputs)

    # -- candidate execution ----------------------------------------------------

    def variant_fn(self, variant: ExchangeVariant, degree: int) -> Callable[[Any], Any]:
        """Build the callable for one (variant, degree) candidate."""
        shape = launch_shape(self.lengths, variant, degree)

        def run(inputs: Any) -> Any:
            if self.kernel is not None:
                return self.kernel(inputs, shape)
            if any(t.is_cuda for t in _leaves(inputs)):
                raise ValueError(f"{self.name}: no kernel for CUDA tensors")
            return run_plain(self.body, inputs, shape)

        run.__name__ = f"{self.name}_{variant.label(self.dim_names)}_d{degree}"
        return run

    # -- AT region ----------------------------------------------------------------

    def at_region(
        self,
        degrees: Sequence[int] = (1, 2, 4, 8, 16, 32),
        variants: Optional[Sequence[ExchangeVariant]] = None,
    ) -> ATRegion:
        """Bracket this nest as an AT region over (variant × degree).

        This is the ``!oat$ install Exchange region start/end`` +
        dynamic-thread-count PP of the paper, as one joint space (§V co-tunes
        them because the optimal degree depends on the variant).
        """
        vs = tuple(variants or enumerate_exchange_variants(len(self.lengths)))
        space = ParamSpace(
            [
                PerfParam("variant", tuple((v.m, v.j) for v in vs)),
                PerfParam("degree", tuple(int(d) for d in degrees)),
            ]
        )

        def instantiate(point: Mapping[str, Any]) -> Callable[[Any], Any]:
            m, j = point["variant"]
            return self.variant_fn(ExchangeVariant(m=m, j=j), point["degree"])

        return ATRegion(
            name=self.name, space=space, instantiate=instantiate, oracle=self.reference
        )
