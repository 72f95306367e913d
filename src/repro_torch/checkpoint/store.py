"""npz checkpoints in the reference's byte layout.

Counterpart of ``repro.checkpoint.store`` (``save_checkpoint``,
``load_checkpoint``, ``load_meta``): leaves are stored under their
``/``-joined tree paths, and ``__meta__`` holds a JSON object with
``step``, ``keys`` and ``dtypes``.  bfloat16 leaves are written as raw
2-byte ``V2`` values with ``dtypes[key] = "bfloat16"``, exactly as the
reference writes them, and read back by viewing the bytes as ``int16`` and
then as ``torch.bfloat16`` — no ``ml_dtypes`` needed.  The two packages
load each other's archives bit for bit.

Experiment checkpoints (:func:`save_experiment`) store the whole
:class:`repro_torch.core.state.EngineState` as one tree (params, optimizer
state, participation, communication, graph, async and privacy state; the
absent ``None`` components and ``None`` leaves are skipped, as JAX skips
them) under the reference's key paths (``params/...``,
``async_state/buffer/...``), with the
:class:`repro_torch.api.ExperimentSpec` JSON in the metadata under
``"spec"``: :func:`load_spec` + :func:`repro_torch.api.build` rebuild the
exact engine, :func:`load_experiment` restores the state into it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.convert import from_numpy, to_numpy
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

PyTree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "load_meta",
           "save_experiment", "load_spec", "load_experiment"]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def save_checkpoint(path: str, tree: PyTree, step: int = 0,
                    metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for p, v in tree_flatten_with_path(tree):
        if v is None:                # JAX's convention: an empty subtree
            continue
        key = _path_str(p)
        if isinstance(v, torch.Tensor):
            arr = to_numpy(v)
            if v.dtype == torch.bfloat16:
                arr = arr.view("V2")         # the reference's raw layout
                dtypes[key] = "bfloat16"
        else:
            arr = np.asarray(v)
        arrays[key] = arr
    # reserved fields win over user metadata
    meta = {**(metadata or {}), "step": step, "keys": sorted(arrays),
            "dtypes": dtypes}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _to_tensor(arr: np.ndarray, dtype_name: str | None,
               device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return from_numpy(arr.view(np.int16), device).view(torch.bfloat16)
    if dtype_name is not None:
        raise ValueError(f"unsupported stored dtype {dtype_name!r}")
    return from_numpy(arr, device)


def load_checkpoint(path: str, like: PyTree, *,
                    device=None) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (shapes validated) on
    ``device`` (``None`` means CUDA).

    ``like``'s leaves only need ``.shape``: ``meta``-device tensors
    (:func:`repro_torch.models.transformer.param_specs`) describe a
    full-width agent stack without allocating it.  Leaves are moved to the
    device one at a time, so the host holds one leaf at a time.  ``None``
    leaves of ``like`` stay ``None``.
    """
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = []
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        dtypes = meta.get("dtypes", {})
        for p, v in tree_flatten_with_path(like):
            if v is None:
                leaves.append(None)
                continue
            key = _path_str(p)
            if key not in z:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            if hasattr(v, "shape") and tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(v.shape)}")
            leaves.append(_to_tensor(arr, dtypes.get(key), dev))
    return tree_unflatten(like, leaves), meta


def load_meta(path: str) -> dict:
    """Read just the metadata of a checkpoint (no tree restore)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


# ---------------------------------------------------------------------------
# experiment checkpoints: EngineState as one tree + the spec alongside
# ---------------------------------------------------------------------------

def _state_tree(state) -> dict:
    """An :class:`EngineState` as the dict of its present components, in
    field order (the reference's ``GetAttrKey`` paths)."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None}


def save_experiment(path: str, state, *, spec=None, step: int = 0,
                    metadata: dict | None = None) -> None:
    """Save a whole :class:`~repro_torch.core.state.EngineState` as one
    tree, with ``spec`` (an :class:`repro_torch.api.ExperimentSpec`)
    embedded as JSON under the reserved ``"spec"`` key of the metadata."""
    meta = dict(metadata or {})
    if spec is not None:
        meta["spec"] = spec.to_json(indent=None)
    save_checkpoint(path, _state_tree(state), step=step, metadata=meta)


def load_spec(path: str):
    """The :class:`repro_torch.api.ExperimentSpec` embedded in a
    checkpoint, or None for a spec-less (plain-tree) checkpoint."""
    meta = load_meta(path)
    if "spec" not in meta:
        return None
    from repro_torch.api.spec import ExperimentSpec   # lazy: store <-> api
    return ExperimentSpec.from_json(meta["spec"])


def load_experiment(path: str, like_state, *,
                    device=None) -> tuple[Any, dict]:
    """Restore an :class:`EngineState` checkpoint into ``like_state`` on
    ``device`` (``None`` means CUDA).

    ``like_state`` decides which components are restored: a template with
    ``opt_state=None`` restores only the params (and the other components
    it carries) even if the archive holds more; serving needs just the
    iterate (and, for an async run, the clocks).
    """
    tree, meta = load_checkpoint(path, _state_tree(like_state),
                                 device=device)
    return dataclasses.replace(like_state, **tree), meta
