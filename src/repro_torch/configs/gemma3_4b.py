"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 -- 5:1 local:global, 128k context, qk-norm."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab=262144,
        activation="gelu",
        local_window=1024,
        global_period=6,            # 5 local : 1 global
        rope_base=1_000_000.0,
        rope_base_local=10_000.0,
        qk_norm=True,
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
    )
