"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-32B]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=384,
    qkv_bias=True,
)
