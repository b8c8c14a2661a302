from . import ops, ref
from .flash_attention import attention_plain, counter, flash_attention_cuda
