from . import ops, ref
from .ssm_scan import counter, ssm_scan_cuda, ssm_scan_plain
