"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 -- anyres tiling. Backbone only; the vision tower is a stub:
input_specs provides precomputed patch embeddings (576 tokens per image
tile, prepended to the text tokens)."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig

N_IMAGE_TOKENS = 576  # one anyres base tile of 24x24 patches


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        activation="silu",
        rope_base=1_000_000.0,
        tie_embeddings=False,
        modality="vlm",
    )
