"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355].

64 layers, d_model 4096, expand 2 (d_inner 8192), ssm_state 16, conv 4.
Sub-quadratic: long_500k runs.  n_heads/n_kv_heads are unused placeholders
(family=ssm has no attention)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_conv=4,
    expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    ssm_state=4,
    d_conv=4,
    expand=2,
)
