"""qwen1.5-32b — dense, QKV bias, GQA kv=40 (==heads, i.e. MHA-equal).
[hf:Qwen/Qwen1.5-0.5B family; hf]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    gated_mlp=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
