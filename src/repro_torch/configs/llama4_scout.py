"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192, vocab=202048, MoE 16 experts top-1 + shared expert, sigmoid
router weights applied to the expert *input* (llama4 style). Early-fusion
multimodality is out of backbone scope per the assignment (text tokens only).
"""

from repro_torch.configs import register
from repro_torch.models.transformer import ModelConfig


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        vocab=202048,
        n_experts=16,
        top_k=1,
        moe_d_ff=8192,
        n_shared_experts=1,
        router_weights_before=True,
        activation="silu",
        rope_base=500_000.0,
        tie_embeddings=False,
    )
