"""DiT-XL — paper Table 2 diffusion transformer (compute-intensive case).
Modeled as a bidirectional dense transformer over 256 latent patches."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dit-xl",
    family="dense",
    num_layers=28,
    d_model=1152,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4608,
    vocab_size=8,              # in/out channels; negligible embed
    gated_mlp=False,
    mlp_act="gelu",
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, gated_mlp=False)
