"""qwen3-32b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "Qwen3 (qk_norm, GQA) [hf:Qwen/Qwen3-8B]"

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    rope_theta=1e6, mlp_act="silu", qk_norm=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    rope_theta=1e6, mlp_act="silu", qk_norm=True, dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16)
