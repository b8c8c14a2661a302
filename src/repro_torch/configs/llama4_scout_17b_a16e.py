"""llama4-scout-17b-a16e — MoE 16 experts top-1 [hf:meta-llama/Llama-4-Scout-17B-16E].

Text backbone only (the early-fusion image frontend is out of scope for the
LM shape cells; docs/design.md §4)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=16,
    top_k=1,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    n_experts=4,
    top_k=1,
)
