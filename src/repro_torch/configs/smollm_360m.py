"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "SmolLM (llama-arch small) [hf:HuggingFaceTB/SmolLM-135M]"

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    num_layers=2, d_model=192, num_heads=3, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True, dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16,
                          tp=False, mix_path="sparse")
