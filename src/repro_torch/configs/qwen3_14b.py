"""qwen3-14b — dense, qk-norm, GQA kv=8.  [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    gated_mlp=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, qk_norm=True)
