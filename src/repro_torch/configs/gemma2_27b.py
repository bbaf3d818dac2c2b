"""Gemma2-27B — paper Table 2 evaluation model (GQA)."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    gated_mlp=True,
    mlp_act="gelu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
