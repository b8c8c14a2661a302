from . import ops, ref
from .stress import counter, stress_cuda, stress_plain
