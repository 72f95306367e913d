"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The audio frontend (EnCodec) is stubbed: the model consumes
4 parallel codebook token streams (vocab 2048 each, summed embeddings, one
LM head per codebook).  The published model uses learned positional
embeddings; the reference uses RoPE, and so does the port.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "MusicGen (decoder-only over EnCodec tokens) [arXiv:2306.05284]"

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    rope_theta=1e4, mlp_act="gelu", num_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128,
    rope_theta=1e4, mlp_act="gelu", num_codebooks=4, dtype="float32",
)

# the reference's parallel layout: pure data parallelism (d_model is too
# small to amortize tensor-parallel activation all-reduces)
PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16,
                          tp=False, mix_path="sparse")
