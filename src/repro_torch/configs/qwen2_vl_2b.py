"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

Vision frontend is a STUB: input_specs supplies (B, 256, d_model) patch
embeddings occupying the first 256 positions, plus (3, B, S) M-RoPE position
ids (temporal/height/width)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=32,
    mrope=True,
    mrope_sections=(4, 6, 6),
    n_vision_tokens=8,
    tie_embeddings=True,
)
