"""Synthetic data generators (the language-model half).

Counterpart of ``repro.data.synthetic``.  The §VII regression half
(``make_regression_problem``, ``make_block_sampler``) waits for its slice
(ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import torch

__all__ = ["lm_token_batch"]


def lm_token_batch(key: torch.Generator, shape: tuple[int, ...], vocab: int,
                   dtype=torch.int32) -> dict:
    """Synthetic next-token-prediction batch: uniform tokens on the
    generator's device and labels shifted by one (last label 0)."""
    tokens = torch.randint(0, vocab, shape, generator=key, device=key.device,
                           dtype=dtype)
    labels = torch.cat([tokens[..., 1:], torch.zeros_like(tokens[..., :1])],
                       dim=-1)
    return {"tokens": tokens, "labels": labels}
