"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 -- parallel attention + mamba heads in every
block (outputs per-branch normalized then averaged), 128 meta tokens,
sliding-window attention with a few global layers."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("hymba-1.5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        activation="silu",
        local_window=1024,
        global_period=16,          # ~2 global layers (paper: first/mid/last)
        d_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        n_meta_tokens=128,
        tie_embeddings=True,
    )
