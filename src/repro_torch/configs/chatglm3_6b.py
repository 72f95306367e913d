"""chatglm3-6b — dense, GQA kv=2, 2d(partial) RoPE [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "ChatGLM family [arXiv:2406.12793]; RoPE applied to half head dim"

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024,
    rotary_pct=0.5, rope_theta=1e4, mlp_act="silu",
)

SMOKE = ModelConfig(
    name="chatglm3-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    rotary_pct=0.5, rope_theta=1e4, mlp_act="silu", dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16)
