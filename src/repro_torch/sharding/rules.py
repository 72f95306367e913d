"""Sharding rules: parameter, batch and cache partition specs for a mesh.

Counterpart of ``repro.sharding.rules``.  The specs are plain host logic:
a :class:`PartitionSpec` is a tuple of axis entries, each ``None``
(replicated), a mesh axis name, or a tuple of names (a composite axis).
The rules take any mesh that exposes its axis sizes by name: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``) or any object whose ``shape`` maps axis names to sizes (as a
``jax.sharding.Mesh`` does).  :func:`named` maps a spec tree onto the
``Shard(d)`` / ``Replicate()`` placements of a ``DeviceMesh``.

Conventions (Megatron-style tensor parallelism over the ``model`` axis):
  * attention qkv projections: output dim over model
  * attention output projection: input dim over model
  * MLP up/gate: output dim over model; down: input dim over model
  * MoE expert weights: expert dim over model (expert parallelism)
  * embeddings / lm head: vocab dim over model
  * SSM in/out projections: inner dim over model
  * FSDP: additionally shard the non-TP dim of 2-D+ weights over the
    ``data`` axis (only legal when the agent axis is not ``data``).

Every axis assignment is divisibility-guarded: a dim that does not divide
the mesh axis falls back to replicated (correct, just less sharded).
"""
from __future__ import annotations

from typing import Any, Mapping

from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

PyTree = Any

__all__ = ["PartitionSpec", "axis_sizes", "param_pspecs", "add_agent_axis",
           "agent_stack_pspec", "batch_pspec", "serve_batch_pspec",
           "cache_pspecs", "named"]


class PartitionSpec:
    """A tuple of per-dim axis entries that the port's tree utilities
    treat as one leaf (a bare tuple would be flattened as a container).
    Iterates, indexes and compares like its tuple.  Entries are canonical,
    as JAX's ``PartitionSpec`` makes them: a one-name tuple is the bare
    name, an empty one ``None``."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            (e[0] if len(e) == 1 else (e or None))
            if isinstance(e, tuple) else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any mesh whose
    ``shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"{type(mesh).__name__} exposes no axis sizes by name")


def _axsize(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _maybe(sizes: dict, axis, dim: int):
    """Use ``axis`` only if ``dim`` divides the axis size."""
    if axis is None:
        return None
    return axis if dim % _axsize(sizes, axis) == 0 else None


def _axis_entry(axes):
    """Canonical spec entry for a list of mesh axes: None when empty, the
    bare axis name for one, a tuple only for a true composite."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _leaf_rule(path: str, shape: tuple, sizes: dict, fsdp_axis,
               tp_enabled: bool = True) -> PartitionSpec:
    """Inner (agent-free) spec for a parameter leaf."""
    name = path.split("/")[-1]
    stacked = "segments/" in path  # leading layer dim from scan stacking
    off = 1 if stacked else 0
    dims = tuple(shape[off:])

    def spec(*entries):
        return P(*([None] * off + list(entries)))

    tp = "model" if tp_enabled else None
    if name in ("scale", "A_log", "D", "dt_bias", "conv_b", "b"):
        return spec(*([None] * len(dims)))
    if path.endswith("embed") or name == "embed":
        if len(dims) == 3:     # (nq, V, D) audio codebooks
            return spec(None, _maybe(sizes, tp, dims[1]),
                        _maybe(sizes, fsdp_axis, dims[2]))
        return spec(_maybe(sizes, tp, dims[0]),
                    _maybe(sizes, fsdp_axis, dims[1]))
    if name == "lm_head":
        if len(dims) == 3:     # (nq, D, V)
            return spec(None, _maybe(sizes, fsdp_axis, dims[1]),
                        _maybe(sizes, tp, dims[2]))
        return spec(_maybe(sizes, fsdp_axis, dims[0]),
                    _maybe(sizes, tp, dims[1]))
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "router", "w"):
        if len(dims) == 3:     # MoE (E, D, F): experts over model, FSDP on D
            return spec(_maybe(sizes, tp, dims[0]),
                        _maybe(sizes, fsdp_axis, dims[1]), None)
        return spec(_maybe(sizes, fsdp_axis, dims[0]),
                    _maybe(sizes, tp, dims[1]))
    if name in ("wo", "w_down", "out_proj"):
        if len(dims) == 3:     # MoE (E, F, D)
            return spec(_maybe(sizes, tp, dims[0]), None,
                        _maybe(sizes, fsdp_axis, dims[1]))
        return spec(_maybe(sizes, tp, dims[0]),
                    _maybe(sizes, fsdp_axis, dims[1]))
    if name == "conv_w":       # (k, conv_dim)
        return spec(None, _maybe(sizes, tp, dims[1]))
    return spec(*([None] * len(dims)))


def _flatten_paths(tree: PyTree) -> list:
    """[("a/b/c", leaf)] in the tree's flatten order."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def param_pspecs(specs: PyTree, mesh, *, fsdp: bool = False,
                 tp: bool = True) -> PyTree:
    """Spec tree for an (agent-free) parameter tree of anything with a
    ``shape`` (the port's ``param_specs`` meta tensors).

    ``tp=False`` replicates parameters over the ``model`` axis (pure data
    parallelism), for models whose d_model is too small to amortize TP
    activation all-reduces.
    """
    sizes = axis_sizes(mesh)
    fsdp_axis = "data" if (fsdp and "data" in sizes) else None
    out = [_leaf_rule(path, tuple(v.shape), sizes, fsdp_axis, tp)
           for path, v in _flatten_paths(specs)]
    return tree_unflatten(specs, out)


def add_agent_axis(pspecs: PyTree, agent_axis: str | None) -> PyTree:
    """Prepend the agent axis to every leaf spec (stacked-agent layout)."""
    return tree_map(lambda s: P(agent_axis, *tuple(s)), pspecs)


def agent_stack_pspec(mesh, agent_axis: str | None, *, num_agents: int,
                      ndim: int = 2) -> PartitionSpec:
    """Spec for an agent-stacked operand (K, ...): the leading K axis over
    ``agent_axis``, everything else replicated.

    The (K, M) parameter stack, the (K, D) neighbor-index table and the
    robust gather intermediates shard their agent rows across the mesh
    dimension, so no device holds K model copies.  A K that does not
    divide the axis size falls back to replicated (correct, just less
    sharded), as does an axis name the mesh does not carry.
    """
    sizes = axis_sizes(mesh)
    if agent_axis is not None and agent_axis not in sizes:
        agent_axis = None
    return P(_maybe(sizes, agent_axis, num_agents), *([None] * (ndim - 1)))


def batch_pspec(mesh, *, agent_axis: str | None, ndim: int,
                leading_T: bool = True, tp: bool = True,
                batch: int | None = None) -> PartitionSpec:
    """Spec for block-batch leaves (T, K, B, ...): agent over agent_axis,
    per-agent batch over the remaining data-like axes.  With ``tp=False``
    the ``model`` axis also carries batch (pure DP).  When ``batch`` is
    given, axes are dropped greedily until their product divides it."""
    sizes = axis_sizes(mesh)
    data_axes = [a for a in ("pod", "data") if a in sizes and a != agent_axis]
    if not tp and "model" in sizes:
        data_axes.append("model")

    def prod(axes):
        out = 1
        for a in axes:
            out *= sizes[a]
        return out

    while batch is not None and data_axes and batch % prod(data_axes):
        data_axes.pop()
    b_axis = _axis_entry(data_axes)
    entries = ([None] if leading_T else []) + [agent_axis, b_axis]
    entries += [None] * (ndim - len(entries))
    return P(*entries)


def serve_batch_pspec(mesh, batch: int, ndim: int) -> PartitionSpec:
    """Spec for serving inputs (B, ...): batch over all data-like axes."""
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in data_axes:
        n *= sizes[a]
    b_axis = _axis_entry(data_axes) if (data_axes and batch % n == 0) else None
    return P(b_axis, *([None] * (ndim - 1)))


def cache_pspecs(cache_spec: PyTree, mesh, batch: int) -> PyTree:
    """Specs for the decode cache.

    KV leaves (L, B, C, Kv, Dh): batch over the data axes when divisible,
    otherwise the cache length C over ``data`` (long context, batch 1).
    SSM state (L, B, H, P, N): heads over model.
    """
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in data_axes:
        n *= sizes[a]
    shard_batch = batch % n == 0 and n > 1

    def rule(path: str, v) -> PartitionSpec:
        name = path.split("/")[-1]
        shape = tuple(v.shape)
        if name in ("k", "v"):
            _, _, C, Kv, _ = shape
            if shard_batch:
                return P(None, data_axes, None, _maybe(sizes, "model", Kv),
                         None)
            return P(None, None, _maybe(sizes, "data", C),
                     _maybe(sizes, "model", Kv), None)
        if name == "ssm":
            H = shape[2]
            if shard_batch:
                return P(None, data_axes, _maybe(sizes, "model", H), None,
                         None)
            return P(None, None, _maybe(sizes, "model", H), None, None)
        if name == "conv":
            Cd = shape[3]
            if shard_batch:
                return P(None, data_axes, None, _maybe(sizes, "model", Cd))
            return P(None, None, None, _maybe(sizes, "model", Cd))
        return P(*([None] * len(shape)))

    return tree_unflatten(cache_spec, [rule(p, v) for p, v in
                                       _flatten_paths(cache_spec)])


def named(pspecs: PyTree, mesh) -> PyTree:
    """Spec tree -> tree of ``torch.distributed.tensor`` placements: for
    each leaf, one placement per mesh dim, ``Shard(d)`` on the mesh dims
    that tensor dim ``d`` names and ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or axis_sizes(mesh).keys())

    def placements(spec: PartitionSpec) -> tuple:
        where = {}
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    where[a] = d
        return tuple(Shard(where[n]) if n in where else Replicate()
                     for n in names)

    return tree_map(placements, pspecs)
