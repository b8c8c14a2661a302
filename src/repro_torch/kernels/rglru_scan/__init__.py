from . import ops, ref
from .rglru_scan import counter, rglru_scan_cuda, rglru_scan_plain
