"""Frozen counts of the benchmark's yardstick: the card's peaks, the useful
operations of one training block, and each kernel's operations and bytes
at the shapes the cells launch.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W
limit).  A kernel's bound is the larger of its bytes over the memory
bandwidth and its operations over the peak of its inputs' type; each
input byte is read once and each output byte written once.
"""
from __future__ import annotations

import math

__all__ = ["PEAKS", "HBM_BYTES_PER_S", "block_flops", "flash_attention",
           "ssd_intra_chunk", "diffusion_mix", "bound_s", "param_count"]

HBM_BYTES_PER_S = 3.35e12
#: dense peak operations per second by input type
PEAKS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAKS[peak])


def _linear_params(cfg: dict) -> int:
    """Parameters that enter a matrix product at every position of the
    decoder: the layers' projections (no norms, convolutions or biases)."""
    D, L = cfg["d_model"], cfg["num_layers"]
    if cfg.get("ssm_state"):
        di = cfg["ssm_expand"] * D
        heads = di // cfg["ssm_head_dim"]
        per_layer = D * (2 * di + 2 * cfg["ssm_state"] + heads) + di * D
    else:
        H, Kv, Dh, F = (cfg["num_heads"], cfg["num_kv_heads"],
                        cfg["head_dim"], cfg["d_ff"])
        gated = 3 if cfg.get("mlp_act", "silu") == "silu" else 2
        per_layer = 2 * D * H * Dh + 2 * D * Kv * Dh + gated * D * F
    return L * per_layer


def block_flops(cfg: dict, traffic: dict) -> float:
    """Useful operations of one Algorithm-1 block: K agents, T local
    steps, each a forward and backward pass (6 operations per parameter
    and position for the matrix products) through the decoder over B
    sequences of S token positions behind P prefix positions (an image's
    features, which enter as embeddings of their own and are not scored).

    Re-derived from the dry run's ``analytic_flops`` (6 N tokens, plus
    ``6 L_attn B H Dh S W`` for causal attention and ``6 L_mamba tokens
    2 expand D (chunk + state) / head_dim`` for the SSD) at the cell's
    depth, K, T and positions, counting only what the loss needs: the
    head over the S token positions (the dry run counts the embedding
    table and the head both, over every position).  Whatever maps a
    prefix to the model width, and recomputation, are not counted.
    """
    K, T, B = traffic["agents"], traffic["local_steps"], traffic["batch"]
    S = traffic["seq"]
    P = traffic.get("image_positions", 0)
    D, V = cfg["d_model"], cfg["vocab_size"]
    pos = S + P
    dense = 6 * _linear_params(cfg) * pos + 6 * V * D * S
    attn = ssm = 0
    if cfg.get("num_heads"):
        attn = 6 * cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] \
            * pos * pos
    if cfg.get("ssm_state"):
        ssm = (6 * cfg["num_layers"] * pos * 2 * cfg["ssm_expand"] * D
               * (cfg["ssm_chunk"] + cfg["ssm_state"])
               // cfg["ssm_head_dim"])
    return float(K * T * B * (dense + attn + ssm))


def flash_attention(B: int, S: int, H: int, Kv: int, Dh: int,
                    elem_bytes: int = 2) -> tuple[float, float, str]:
    """(operations, bytes, peak) of one causal forward launch: Q K^T and
    P V over the S (S + 1) / 2 kept pairs of each head; q read and out
    written, k and v read."""
    pairs = S * (S + 1) // 2
    flops = 2 * 2 * B * H * pairs * Dh
    nbytes = elem_bytes * (2 * B * S * H * Dh + 2 * B * S * Kv * Dh)
    return float(flops), float(nbytes), "bfloat16" if elem_bytes == 2 \
        else "float32"


def ssd_intra_chunk(b: int, s: int, h: int, p: int, n: int, chunk: int,
                    bc_bytes: int = 2) -> tuple[float, float, str]:
    """(operations, bytes, peak) of one intra-chunk SSD launch: xd and dA
    read, Y_diag, the chunk states and the cumulative dA written in
    float32, B and C read in their type; C B^T once per chunk, then the
    masked product with xd and the chunk states (split TF32 on the tensor
    cores, at the TF32 peak)."""
    nc = s // chunk
    nbytes = (4 * (2 * b * s * h * p + 2 * b * s * h + b * nc * h * p * n)
              + 2 * bc_bytes * b * s * n)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * b * nc * tri * n + 2 * b * h * nc * (tri * p + chunk * p * n)
    return float(flops), float(nbytes), "tf32"


def diffusion_mix(K: int, M: int) -> tuple[float, float, str]:
    """(operations, bytes, peak) of one whole combination of a (K, M)
    float32 stack: the stack read and written once, the (K, K) matrix and
    the (K,) mask read once; 2 K operations per output element.  However
    the program tiles it, no combination moves fewer bytes."""
    nbytes = 4 * (2 * K * M + K * K + K)
    flops = 2 * K * K * M
    return float(flops), float(nbytes), "float32"


def param_count(layout: list) -> int:
    """One agent's parameters, from a reference family's layout."""
    return sum(math.prod(shape) for _, shape, _, _ in layout)
