"""The paper's applications on the card: GKV ``exb_realspcal`` (§III/§V)
and Seism3D ``update_stress`` (§IV) as AT loop nests over the Exchange ×
LoopFusion variants and the degree, and Figs. 11–14
(:mod:`.paper_figures`)."""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.arch import ArchSpec, local_arch

# The paper's thread counts on one 32-core FX100 node; 32 stays, so that
# Fig. 11 ("all at 32") has a counterpart.
PAPER_DEGREES = (1, 2, 4, 8, 16, 32)


def degrees(arch: Optional[ArchSpec] = None) -> Tuple[int, ...]:
    """The degrees (CTAs of the directive loop) the apps tune over: the
    paper's, then one, two and four CTAs a streaming multiprocessor (132,
    264 and 528 on an H100 SXM), which play the part of the node's cores
    (docs/design.md §2)."""
    sms = (arch or local_arch()).sm_count
    return PAPER_DEGREES + tuple(k * sms for k in (1, 2, 4))
