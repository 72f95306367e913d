"""mamba2-2.7b — attention-free SSD [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "Mamba2 SSD (state-space duality) [arXiv:2405.21060]"

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=32,
    tie_embeddings=True, dtype="float32",
)

# Adopted §Perf optimization: pure data parallelism — d_model is too small
# to amortize TP activation all-reduces (5.3x collective reduction measured;
# replicated bf16 params fit v5e HBM comfortably at this scale).
PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16,
                          tp=False, mix_path="sparse")
