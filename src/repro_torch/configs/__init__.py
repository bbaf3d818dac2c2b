"""Architecture registry of the port (copy of ``src/repro/configs``).

``get_config(arch_id)`` returns the full config; ``get_smoke_config``
a reduced same-family config for CPU tests.  Every architecture id of the
reference is here: the dense decoders, the MoE family, RWKV6, the hybrid
attention + SSM model, the encoder-decoder with its audio stub and the VLM
with its vision stub, and the paper's Table 2 models.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen3_14b",
    "llama2_13b",
    "gemma_7b",
    "opt_30b",
    "h2o_danube_1_8b",
    "qwen1_5_32b",
    "gemma2_27b",
    "llama2_70b",
    "dit_xl",
    "llama4_maverick_400b_a17b",
    "kimi_k2_1t_a32b",
    "internvl2_1b",
    "rwkv6_7b",
    "whisper_tiny",
    "hymba_1_5b",
]

# canonical dashed ids accepted on the CLI
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "qwen1.5-32b": "qwen1_5_32b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "hymba-1.5b": "hymba_1_5b",
})

# The paper's own evaluation models (Table 2), all ported
PAPER_MODEL_IDS = ["llama2_13b", "gemma2_27b", "opt_30b", "llama2_70b", "dit_xl"]
assert set(PAPER_MODEL_IDS) <= set(ARCH_IDS)


def canonical(arch: str) -> str:
    a = arch.replace("-", "_").replace(".", "_")
    if arch in ALIASES:
        a = ALIASES[arch]
    if a in ARCH_IDS:
        return a
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.smoke_config()


def _shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Default family-preserving reduction for smoke tests."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=max(2, min(4, cfg.num_heads or 2)),
        num_kv_heads=0,  # fixed below
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else 0,
    )
    nh = overrides.get("num_heads", base["num_heads"])
    if cfg.num_heads:
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        base["num_kv_heads"] = max(1, nh // min(ratio, nh))
    else:
        base["num_heads"] = 0
        base["num_kv_heads"] = 0
    if cfg.moe_experts:
        base.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                    moe_d_ff=64 if cfg.moe_d_ff else 0,
                    moe_shared_d_ff=64 if cfg.moe_shared_d_ff else 0,
                    moe_first_dense=min(cfg.moe_first_dense, 1))
    if cfg.sliding_window:
        base["sliding_window"] = 16
    if cfg.encoder_layers:
        base.update(encoder_layers=2, encoder_seq=8)
    if cfg.vision_patches:
        base["vision_patches"] = 4
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
