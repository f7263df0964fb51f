"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, sliding-window attention (4096)
[arXiv:2401.04088; hf].  SWA bounds the KV cache → long_500k RUNS."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, rope_theta=1e6,
    moe_experts=8, moe_top_k=2, sliding_window=4096,
    subquadratic=True,   # window-bounded attention
)
