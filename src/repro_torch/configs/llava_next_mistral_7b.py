"""llava-next-mistral-7b — VLM backbone (anyres tiling)
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision frontend is stubbed: the model takes precomputed patch
embeddings (anyres: 576 base + 4x576 tile tokens = 2880) at the vision
width (1024, ``models.transformer.VISION_DIM``); the projector and the
mistral decoder are implemented.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CITATION = "LLaVA-NeXT (mistral-7b backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]"

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    rope_theta=1e6, mlp_act="silu",
    img_tokens=2880,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    rope_theta=1e6, mlp_act="silu",
    img_tokens=16, dtype="float32",
)

PARALLEL = ParallelConfig(num_agents_single=16, num_agents_multi=16)
