"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
-- local+global alternating (1:1), logit softcap, post-norms."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("gemma2-2b")
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        activation="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        local_window=4096,
        global_period=2,          # alternate local / global
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
    )
