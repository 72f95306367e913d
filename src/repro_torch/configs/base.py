"""Model configurations of the port (counterpart of ``repro.configs.base``).

The fields are the reference's, so a config converts field for field;
``dtype`` stays a string and :attr:`ModelConfig.param_dtype` maps it to a
torch dtype.  The registry lists the reference's ten architectures; an
unknown name raises ``KeyError``.  :data:`INPUT_SHAPES` are the
reference's four dry-run shapes, and :meth:`ModelConfig.total_params` /
:meth:`~ModelConfig.active_params` its parameter-count formula (an
approximation that leaves out the norms, kept as the reference has it).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

__all__ = ["ModelConfig", "ParallelConfig", "ArchBundle", "get_config",
           "ARCH_IDS", "INPUT_SHAPES", "InputShape"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavor
    rope_theta: float = 1e4
    rotary_pct: float = 1.0
    qk_norm: bool = False
    attention_window: int | None = None
    mlp_act: str = "silu"            # silu => SwiGLU; gelu => plain MLP
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_cap_shard: Any = None
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # hybrid layout
    attn_every: int = 0
    shared_attention: bool = False
    # modality
    num_codebooks: int = 0
    img_tokens: int = 0
    # misc
    tie_embeddings: bool = False
    tp_barrier: bool = False
    use_kernels: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    long_context_window: int = 8192

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def block_types(self) -> tuple[str, ...]:
        """Per-layer mixer/ffn type: 'attn' | 'moe' | 'mamba'."""
        if self.family == "moe":
            return ("moe",) * self.num_layers
        if self.family == "ssm":
            return ("mamba",) * self.num_layers
        if self.family == "hybrid":
            if self.attn_every <= 0:
                raise ValueError("hybrid family needs attn_every > 0")
            return tuple("attn" if (i + 1) % self.attn_every == 0 else "mamba"
                         for i in range(self.num_layers))
        return ("attn",) * self.num_layers  # dense / vlm / audio

    def segments(self) -> list[tuple[str, int]]:
        """Contiguous runs of identical block type (scan units)."""
        segs: list[tuple[str, int]] = []
        for t in self.block_types():
            if segs and segs[-1][0] == t:
                segs[-1] = (t, segs[-1][1] + 1)
            else:
                segs.append((t, 1))
        return segs

    def active_params(self) -> int:
        """Approximate active parameter count (MoE: top-k experts only)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """The reference's count: embeddings, attention, MLP, experts and the
    router, the mamba projections; no norms, biases or convolutions."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    emb = V * D * max(1, cfg.num_codebooks or 1)
    n = emb if cfg.tie_embeddings else 2 * emb
    attn = (D * cfg.num_heads * cfg.head_dim * 2
            + D * cfg.num_kv_heads * cfg.head_dim * 2)
    mlp_gated = 3 if cfg.mlp_act == "silu" else 2
    dense_mlp = mlp_gated * D * F
    d_inner = cfg.ssm_expand * D
    mamba = (D * (2 * d_inner + 2 * cfg.ssm_state
                  + d_inner // max(cfg.ssm_head_dim, 1))
             + d_inner * D) if cfg.ssm_state else 0
    for t in cfg.block_types():
        if t == "attn":
            n += attn + (dense_mlp if cfg.d_ff else 0)
        elif t == "moe":
            E = cfg.num_experts_per_token if active_only else cfg.num_experts
            n += attn + mlp_gated * D * cfg.moe_d_ff * E + D * cfg.num_experts
        elif t == "mamba":
            n += mamba
    return n


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model and diffusion map onto devices (reference fields)."""

    num_agents_single: int = 16
    num_agents_multi: int = 16
    agent_axis_single: str = "data"
    agent_axis_multi: str = "data"
    fsdp: bool = False
    tp: bool = True
    remat: bool = True
    local_steps: int = 4
    topology: str = "ring"
    participation: float = 0.9
    mix_path: str = "dense"


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


#: the reference's dry-run shapes (``repro.configs.base.INPUT_SHAPES``)
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    model: ModelConfig
    smoke: ModelConfig
    parallel: ParallelConfig
    citation: str


#: the architectures of the model zoo (the reference's ten)
ARCH_IDS = ("smollm_360m", "mamba2_2p7b", "zamba2_1p2b", "chatglm3_6b",
            "qwen3_32b", "starcoder2_15b", "granite_moe_1b_a400m",
            "kimi_k2_1t_a32b", "llava_next_mistral_7b", "musicgen_medium")

_ALIASES = {"smollm-360m": "smollm_360m", "mamba2-2.7b": "mamba2_2p7b",
            "zamba2-1.2b": "zamba2_1p2b", "chatglm3-6b": "chatglm3_6b",
            "qwen3-32b": "qwen3_32b", "starcoder2-15b": "starcoder2_15b",
            "granite-moe-1b-a400m": "granite_moe_1b_a400m",
            "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
            "llava-next-mistral-7b": "llava_next_mistral_7b",
            "musicgen-medium": "musicgen_medium"}


def get_config(arch: str) -> ArchBundle:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return ArchBundle(model=mod.CONFIG, smoke=mod.SMOKE,
                      parallel=mod.PARALLEL, citation=mod.CITATION)
