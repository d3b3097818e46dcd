"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20, i.e. MHA) d_ff=6912
vocab=151936 -- QKV bias (the Gemmini D-bias path, a native engine feature)."""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("qwen1.5-4b")
def qwen1_5_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab=151936,
        activation="silu",
        qkv_bias=True,
        rope_base=1_000_000.0,
        tie_embeddings=False,
    )
