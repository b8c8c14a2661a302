"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    rope_theta=500000.0,
)
