"""Llama2-13B — paper Table 2 evaluation model (MHA)."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=13824,
    vocab_size=32000,
    gated_mlp=True,
    mlp_act="silu",
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
