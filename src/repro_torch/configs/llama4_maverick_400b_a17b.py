"""llama4-maverick-400b-a17b — MoE 128 experts top-1 + shared expert, GQA kv=8,
early fusion (frontend not assigned -> text only).
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,                 # per-expert hidden
    vocab_size=202048,
    gated_mlp=True,
    mlp_act="silu",
    rope_theta=500_000.0,
    moe_experts=128,
    moe_top_k=1,
    moe_shared_d_ff=8192,      # maverick: shared expert alongside routed top-1
    moe_every=2,               # interleaved MoE (every other layer)
    moe_offset=1,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, moe_every=2, moe_offset=1)
