"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1, MQA) d_ff=6912
vocab=262144 -- 5:1 local:global, 128k context, qk-norm."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        activation="gelu",
        local_window=512,
        global_period=6,            # 5 local : 1 global
        rope_base=1_000_000.0,      # global layers
        rope_base_local=10_000.0,   # local layers
        qk_norm=True,
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
    )
