"""gemma-7b — dense, GeGLU, head_dim=256, kv=16.  [arXiv:2403.08295; hf]"""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    gated_mlp=True,
    mlp_act="gelu",           # GeGLU
    tie_embeddings=True,
    scale_embed=True,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, head_dim=16)
