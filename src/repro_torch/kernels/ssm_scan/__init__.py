from . import ops, ref
from .ssm_scan import (
    bwd_counter, counter, ssm_scan_bwd, ssm_scan_bwd_cuda, ssm_scan_bwd_plain, ssm_scan_cuda,
    ssm_scan_plain,
)
