"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128 -- SSD (state-space duality), expand=2 (d_inner=4096),
64 heads of dim 64, causal conv width 4."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("mamba2-1.3b")
def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        vocab=50280,
        d_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        d_conv=4,
        ssm_chunk=256,
        activation="silu",
        tie_embeddings=True,
    )
