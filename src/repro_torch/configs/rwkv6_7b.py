"""rwkv6-7b (Finch) — attention-free, data-dependent decay WKV recurrence.
[arXiv:2404.05892; hf]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # wkv heads (d_model/64)
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv=True,
    gated_mlp=False,           # rwkv channel-mix is its own 2-matrix form
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, num_heads=4, num_kv_heads=4)
