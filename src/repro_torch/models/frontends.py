"""Modality frontend stubs of the port (counterpart of
``src/repro/models/frontends.py``).

The configs give the transformer backbone only; the frontend supplies
precomputed frame or patch embeddings with the right shapes: normal draws
times 0.02 in bf16, on the caller's device, from a host ``torch.Generator``
seeded with ``seed``, so every device gets the same arrays.  ``jax.random``
cannot be reproduced here, so tests that compare with the reference pass
the reference's arrays instead.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def _stub(shape: tuple, seed: int, device) -> torch.Tensor:
    """Drawn on the host and moved, so that the CPU and the card get the
    same arrays from one seed."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (t * 0.02).to(torch.bfloat16).to(torch.device(device))


def vision_patch_embeddings(cfg: ModelConfig, batch: int, seed: int = 0,
                            device="cuda") -> torch.Tensor:
    """InternViT stub: (B, patches, d_model) precomputed patch embeddings."""
    return _stub((batch, cfg.vision_patches, cfg.d_model), seed, device)


def audio_frame_embeddings(cfg: ModelConfig, batch: int, seed: int = 0,
                           device="cuda") -> torch.Tensor:
    """Whisper conv-frontend stub: (B, encoder_seq, d_model) mel-frame
    embeddings (the two stride-2 convs collapse 3000 mel frames to 1500)."""
    return _stub((batch, cfg.encoder_seq, cfg.d_model), seed, device)


def frontend_embeddings(cfg: ModelConfig, batch: int, seed: int = 0,
                        device="cuda") -> dict:
    """The keyword arguments ``transformer.prefill`` takes for ``cfg``'s
    frontend: ``embeds`` (vision), ``enc_embeds`` (audio) or none."""
    if cfg.frontend == "vision_stub":
        return {"embeds": vision_patch_embeddings(cfg, batch, seed, device)}
    if cfg.frontend == "audio_stub":
        return {"enc_embeds": audio_frame_embeddings(cfg, batch, seed,
                                                     device)}
    return {}
