from . import ops, ref
from .exb import counter, exb_cuda, exb_plain
