"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — mLSTM + sLSTM
blocks at 7:1 (every 8th layer sLSTM) [arXiv:2405.04517; unverified].
No FFN (d_ff=0): mLSTM blocks carry a 2× up-projection, sLSTM a 4/3× FF."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=512, slstm_every=8,
    subquadratic=True,   # linear-time recurrences
)
