"""granite-moe-1b-a400m — MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=48,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    tie_embeddings=True,
)
