"""seamless-m4t-medium [audio]: enc-dec 12L+12L d_model=1024 16H d_ff=4096
vocab=256206 — multimodal [arXiv:2308.11596; hf].  The speech frontend is a
STUB: input_specs provides precomputed frame embeddings.  Decoder-side decode
shapes exercise self-attn KV + static cross-KV caches."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, rope_theta=1e4,
    frontend="audio", frontend_tokens=1024,
    subquadratic=False,
)
