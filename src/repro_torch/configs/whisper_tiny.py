"""whisper-tiny — encoder-decoder, conv audio frontend (stub), 4L d=384.
[arXiv:2212.04356; unverified].  Frontend is a stub: input_specs() provides
precomputed mel-frame embeddings for the encoder."""

from repro_torch.configs import _shrink
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    gated_mlp=False,
    mlp_act="gelu",
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return _shrink(CONFIG, gated_mlp=False)
