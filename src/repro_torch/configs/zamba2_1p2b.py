"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

The published model interleaves a single *shared* full-attention block into
the Mamba2 stack (we place it every 6th layer); its parameters are reused at
every attention slot, matching the paper's weight sharing.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "Zamba2: Mamba2 + shared attn blocks [arXiv:2411.15242]"

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6, shared_attention=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=32,
    attn_every=2, shared_attention=True, dtype="float32",
)

# Adopted §Perf optimization: pure data parallelism — d_model is too small
# to amortize TP activation all-reduces (1.9x collective reduction measured;
# replicated bf16 params fit v5e HBM comfortably at this scale).
PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16,
                          tp=False, mix_path="sparse")
