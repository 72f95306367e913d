"""Model configurations of the port (counterpart of ``repro.configs.base``).

The fields are the reference's, so a config converts field for field;
``dtype`` stays a string and :attr:`ModelConfig.param_dtype` maps it to a
torch dtype.  The registry lists only the architectures the port can run;
asking for another one names the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

__all__ = ["ModelConfig", "ParallelConfig", "ArchBundle", "get_config",
           "ARCH_IDS"]

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
class ArchBundle:
    model: ModelConfig
    smoke: ModelConfig
    parallel: ParallelConfig
    citation: str


#: architectures the port runs today
ARCH_IDS = ("smollm_360m", "mamba2_2p7b", "zamba2_1p2b")

_ALIASES = {"smollm-360m": "smollm_360m", "mamba2-2.7b": "mamba2_2p7b",
            "zamba2-1.2b": "zamba2_1p2b"}

#: the reference's other architectures, with the ROADMAP item that ports
#: what they need
_PENDING = {
    "chatglm3_6b": "queue 1 item 15 (the other dense archs)",
    "qwen3_32b": "queue 1 item 15 (the other dense archs)",
    "starcoder2_15b": "queue 1 item 15 (the other dense archs)",
    "llava_next_mistral_7b": "queue 1 item 17 (image prefix)",
    "musicgen_medium": "queue 1 item 17 (multi-codebook embeddings)",
    "granite_moe_1b_a400m": "queue 1 item 17 (MoE)",
    "kimi_k2_1t_a32b": "queue 1 item 17 (MoE)",
}


def get_config(arch: str) -> ArchBundle:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name in _PENDING:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: see ROADMAP.md "
            f"{_PENDING[mod_name]}")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return ArchBundle(model=mod.CONFIG, smoke=mod.SMOKE,
                      parallel=mod.PARALLEL, citation=mod.CITATION)
