from . import ops, ref
from .rglru_scan import (
    bwd_counter, counter, rglru_scan_bwd, rglru_scan_bwd_cuda, rglru_scan_bwd_plain,
    rglru_scan_cuda, rglru_scan_plain,
)
