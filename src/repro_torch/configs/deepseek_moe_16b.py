"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained,
first layer dense [arXiv:2401.06066; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128, rope_theta=1e4,
    moe_experts=64, moe_top_k=6, moe_shared_experts=2, moe_first_dense=1,
    subquadratic=False,
)
