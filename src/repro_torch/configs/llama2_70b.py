"""Llama2-70B — paper Table 2 evaluation model (GQA kv=8)."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    gated_mlp=True,
    mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
