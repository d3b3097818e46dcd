"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 -- decoder-only over EnCodec tokens, 4 codebooks (embeddings
summed at input, 4 parallel output heads). The EnCodec frontend is a stub:
tokens are the 4-codebook integer frames; conditioning embeddings come via
``extra_embeds``. RoPE replaces sinusoidal positions (TPU adaptation note
in DESIGN.md)."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="dense",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        n_codebooks=4,
        activation="gelu",
        tie_embeddings=False,
        modality="audio",
    )
