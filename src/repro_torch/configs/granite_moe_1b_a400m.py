"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "Granite 3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base]"

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=0, vocab_size=49155,
    num_experts=32, num_experts_per_token=8, moe_d_ff=512,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=512,
    num_experts=4, num_experts_per_token=2, moe_d_ff=64,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True, dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16)
