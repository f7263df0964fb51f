"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + weight-shared attention block
applied every 6th layer [arXiv:2411.15242; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    subquadratic=True,   # SSD backbone; shared-attn uses bounded windows at 500k
    sliding_window=0,
)
