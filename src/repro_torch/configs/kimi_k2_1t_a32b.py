"""kimi-k2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

Total params ~1.03T, active ~31B (matches the paper-table A32B).
Memory note (DESIGN.md §2): K diffusion agents require K full parameter
copies; 2 TB of bf16 params only fits with full FSDP+TP sharding per agent,
so the agent axis rides the `pod` axis (K=2 multi-pod, K=1 single-pod).
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]"

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=112,
    d_ff=0, vocab_size=163840,
    num_experts=384, num_experts_per_token=8, moe_d_ff=2048,
    rope_theta=5e4, mlp_act="silu",
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=512,
    num_experts=4, num_experts_per_token=2, moe_d_ff=64,
    rope_theta=5e4, mlp_act="silu", dtype="float32",
)

PARALLEL = ParallelConfig(
    num_agents_single=1, num_agents_multi=2,
    agent_axis_single="data", agent_axis_multi="pod",
    fsdp=True, local_steps=4, topology="ring", participation=0.9,
)
