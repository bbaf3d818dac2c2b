"""OPT-30B — paper Table 2 evaluation model (MHA, non-gated GELU MLP)."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-30b",
    family="dense",
    num_layers=48,
    d_model=7168,
    num_heads=56,
    num_kv_heads=56,
    d_ff=28672,
    vocab_size=50272,
    qkv_bias=True,
    gated_mlp=False,
    mlp_act="relu",
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, gated_mlp=False)
