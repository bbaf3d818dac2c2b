"""hymba-1.5b — hybrid-head: parallel attention + mamba heads in each layer,
ssm_state=16, SWA on most layers.  [arXiv:2411.13676; hf].  Meta-tokens and the
3-global-layer pattern are simplified to all-SWA + parallel SSM branch (noted
in DESIGN.md)."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    gated_mlp=True,
    mlp_act="silu",
    sliding_window=1024,
    swa_layers="all",
    ssm_state=16,
    hybrid_parallel_ssm=True,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, num_heads=4, num_kv_heads=2, head_dim=16,
                   ssm_state=4)
