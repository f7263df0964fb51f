"""Model configuration for the assigned architectures (one dataclass, many
families), a copy of the reference's ``repro.models.config``.  Exact
full-scale configs live in ``repro_torch/configs/<arch>.py``; ``reduced()``
derives the CPU smoke-test variant."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: int = 0        # >0: SWA (mixtral)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_first_dense: int = 0       # deepseek: first k layers dense
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0            # zamba2: shared attn block period
    # xLSTM
    slstm_every: int = 0           # every k-th layer is sLSTM (0 = none)
    # enc-dec (audio)
    enc_layers: int = 0
    # frontend stubs
    frontend: str = ""             # "vision" | "audio" | ""
    frontend_tokens: int = 576     # prepended patch/frame embeddings
    # numerics / training
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full = nothing saved (the port's only policy;
                                 # "dots"/"outs" raise NotImplementedError)
    unroll: bool = False    # the reference's Python-loop layers instead of
                            # lax.scan; accepted, the port always loops
    # serving
    subquadratic: bool = False     # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so embedding/head shard on any
        power-of-two TP width (seamless: 256206 → 256256)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        def shrink_layers(n):
            return max(2, min(n, 4))
        kw = dict(
            n_layers=shrink_layers(self.n_layers),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            head_dim=16,
            moe_experts=min(self.moe_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_shared_experts=min(self.moe_shared_experts, 1),
            moe_first_dense=min(self.moe_first_dense, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            enc_layers=shrink_layers(self.enc_layers) if self.enc_layers else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            frontend_tokens=8 if self.frontend else 0,
            dtype="float32",
            remat=False,
        )
        return dataclasses.replace(self, **kw)


# the four assigned input-shape cells (shared by all LM archs)
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
