"""recurrentgemma-2b — RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427].

26 layers = 8 × (rec, rec, attn) + (rec, rec) tail.  MQA (kv=1) with
head_dim 256, sliding window 2048.  Sub-quadratic: long_500k runs."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=5,  # 1 full group + (rec, rec) tail — exercises both paths
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
    block_pattern=("rec", "rec", "attn"),
    lru_width=64,
    local_window=16,
    tie_embeddings=True,
)
