"""starcoder2-15b — dense GQA, RoPE, 4k sliding window [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "StarCoder2 [arXiv:2402.19173]; published 4096 sliding window"

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    rope_theta=1e5, mlp_act="gelu", attention_window=4096,
    long_context_window=4096,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    rope_theta=1e5, mlp_act="gelu", attention_window=64,
    long_context_window=64, dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16)
