"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
The anyres vision frontend is a STUB: input_specs provides precomputed patch
embeddings (B, 576, d_model) prepended to the token stream."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, rope_theta=5e6,
    frontend="vision", frontend_tokens=576,
    subquadratic=False,
)
