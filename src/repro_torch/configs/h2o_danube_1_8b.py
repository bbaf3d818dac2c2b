"""h2o-danube-1.8b — dense, llama+mistral mix, GQA kv=8, sliding-window attn.
[arXiv:2401.16818; hf]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    gated_mlp=True,
    mlp_act="silu",
    sliding_window=4096,
    swa_layers="all",
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
