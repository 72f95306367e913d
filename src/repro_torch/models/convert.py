"""Carry parameter trees between the reference (numpy leaves) and the port.

The reference's trees (``{"embed", "segments": {"00.attn.032": {...}},
"final_norm"}``) map onto the port's with the same key paths, so conversion
is leaf by leaf.  bfloat16 crosses as its raw 16 bits: numpy has no
bfloat16 of its own (the reference's arrays carry ``ml_dtypes.bfloat16``,
which the port never imports), so a bfloat16 leaf is viewed as ``int16``
on one side and as ``torch.bfloat16`` on the other.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["params_from_jax", "stacked_params_from_jax", "to_numpy",
           "from_numpy"]


def from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One numpy leaf to a tensor on ``device`` (bfloat16 bit-exact)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:          # e.g. jax.device_get's buffers
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor to numpy on the host; bfloat16 comes back as its raw bits
    in an ``int16`` array (callers that know the dtype reinterpret it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def params_from_jax(tree: PyTree, *, device=None) -> PyTree:
    """Reference parameter tree (numpy leaves, e.g. ``jax.device_get`` of
    ``repro.models.transformer.init_params``) -> the port's tree of tensors
    on ``device`` (``None`` means CUDA), same key paths."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(a, dev), tree)


def stacked_params_from_jax(tree: PyTree, num_agents: int, *,
                            device=None) -> PyTree:
    """:func:`params_from_jax` for a (K, ...)-stacked agent tree; checks
    that every leaf carries the leading agent axis."""
    for leaf in tree_leaves(tree):
        if np.ndim(leaf) == 0 or np.shape(leaf)[0] != num_agents:
            raise ValueError(f"leaf of shape {np.shape(leaf)} lacks the "
                             f"leading agent axis of size {num_agents}")
    return params_from_jax(tree, device=device)
