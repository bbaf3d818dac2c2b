"""kimi-k2-1t-a32b — trillion-param MoE: 384 experts top-8 + shared expert,
d_ff(expert)=2048, 64 q-heads GQA kv=8, dense first layer (DeepSeek-V3 style).
[arXiv:2501.kimi2 paper-table; unverified]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=18432,                # dense-layer / shared reference hidden
    vocab_size=163840,
    head_dim=112,              # 7168/64
    gated_mlp=True,
    mlp_act="silu",
    moe_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,             # per-expert hidden (assignment: d_ff=2048)
    moe_shared_d_ff=2048,
    moe_first_dense=1,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, moe_first_dense=1)
