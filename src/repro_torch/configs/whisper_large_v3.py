"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

Conv/mel frontend is a STUB: input_specs supplies (B, 1500, d_model) frame
embeddings.  32 encoder + 32 decoder layers, MHA (kv == heads), GELU MLP,
tied embeddings.  Assigned seq lengths apply to the decoder side."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    n_encoder_layers=32,
    encoder_len=1500,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_len=24,
    tie_embeddings=True,
)
