"""internvl2-1b — VLM: InternViT frontend (stub) + Qwen2-0.5B-style backbone,
GQA kv=2.  [arXiv:2404.16821; hf].  The assignment specifies the transformer
BACKBONE; the vision frontend is a stub supplying precomputed patch embeddings
via input_specs()."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    gated_mlp=True,
    mlp_act="silu",
    tie_embeddings=True,
    frontend="vision_stub",
    vision_patches=256,          # one 448x448 tile -> 256 visual tokens
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG)
