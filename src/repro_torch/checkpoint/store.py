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

Both directions stream.  A save writes each ``.npy`` member from the
leaf's own buffer: a host leaf in place, in 64 MiB pieces (``np.savez``
writes the same bytes through a 16 MiB ``tobytes`` copy at a time), a
card's leaf through two pinned 64 MiB buffers, piece i+1 copied off the
card while piece i is written.  A load reads
each stored member's data straight from its offset in the file into the
destination: on the CPU into the tensor's own buffer, on a card through
two pinned 64 MiB buffers, one filled from the file while the other is
copied to the card.  This read skips the zip CRC check that
``np.load`` makes; a compressed, Fortran-ordered or big-endian member
goes through ``np.load`` and keeps it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import zipfile
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


_CHUNK = 64 << 20        # bytes a write or a staged copy moves at a time


class _Staging:
    """Two pinned 64 MiB host buffers taking turns between the file and a
    card: one is filled (or written out) while the other's copy runs."""

    def __init__(self):
        self.bufs = [torch.empty(_CHUNK, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.done = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0

    def _next(self):
        buf, done = self.bufs[self.turn], self.done[self.turn]
        self.turn ^= 1
        return buf, done

    def read(self, f, out: torch.Tensor) -> None:
        """The next ``out.numel()`` bytes of ``f`` into ``out`` (uint8,
        on a card)."""
        for i in range(0, out.numel(), _CHUNK):
            n = min(_CHUNK, out.numel() - i)
            buf, done = self._next()
            done.synchronize()               # its previous copy has ended
            _readinto(f, buf[:n])
            out[i:i + n].copy_(buf[:n], non_blocking=True)
            done.record()

    def write(self, fid, data: torch.Tensor) -> None:
        """``data`` (uint8, on a card) to ``fid``: chunk i+1's copy to the
        host runs while chunk i is written."""
        held = None
        for i in range(0, data.numel(), _CHUNK):
            n = min(_CHUNK, data.numel() - i)
            buf, done = self._next()
            buf[:n].copy_(data[i:i + n], non_blocking=True)
            done.record()
            if held is not None:
                self._flush(fid, *held)
            held = buf[:n], done
        if held is not None:
            self._flush(fid, *held)

    @staticmethod
    def _flush(fid, buf, done) -> None:
        done.synchronize()
        fid.write(memoryview(buf.numpy()))


def _write_member(zf: zipfile.ZipFile, key: str, v, stage) -> bool:
    """One ``.npy`` member, as ``np.savez`` writes it, from ``v``'s own
    buffer: a CPU tensor or array in place, a card's tensor through the
    staging buffers (``stage()`` gives them).  Returns whether ``v`` is
    bfloat16 (stored as the reference's raw ``V2`` bytes)."""
    bf16 = isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
    on_card = isinstance(v, torch.Tensor) and v.device.type != "cpu"
    if isinstance(v, torch.Tensor):
        v = v.detach().contiguous()
        dtype = (np.dtype("V2") if bf16 else
                 torch.empty(0, dtype=v.dtype).numpy().dtype)
    else:
        v = np.asarray(v)
        dtype = v.dtype
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        if dtype.hasobject or dtype.kind == "U":
            np.lib.format.write_array(fid, v, allow_pickle=False)
            return bf16
        header = {"descr": np.lib.format.dtype_to_descr(dtype),
                  "fortran_order": False, "shape": tuple(v.shape)}
        try:
            np.lib.format.write_array_header_1_0(fid, header)
        except ValueError:                   # too long for version 1.0
            np.lib.format.write_array_header_2_0(fid, header)
        if on_card:
            stage().write(fid, v.reshape(-1).view(torch.uint8))
            return bf16
        if isinstance(v, torch.Tensor):
            v = to_numpy(v)
        data = memoryview(np.ascontiguousarray(v).reshape(-1).view(np.uint8))
        for i in range(0, len(data), _CHUNK):
            fid.write(data[i:i + _CHUNK])
    return bf16


def save_checkpoint(path: str, tree: PyTree, step: int = 0,
                    metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"                 # as np.savez names it
    keys, dtypes, staging = [], {}, []

    def stage():
        if not staging:
            staging.append(_Staging())
        return staging[0]

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for p, v in tree_flatten_with_path(tree):
            if v is None:            # JAX's convention: an empty subtree
                continue
            key = _path_str(p)
            keys.append(key)
            if _write_member(zf, key, v, stage):
                dtypes[key] = "bfloat16"
        # reserved fields win over user metadata
        meta = {**(metadata or {}), "step": step, "keys": sorted(keys),
                "dtypes": dtypes}
        _write_member(zf, "__meta__", np.asarray(json.dumps(meta)), stage)


def _to_tensor(arr: np.ndarray, dtype_name: str | None,
               device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return from_numpy(arr.view(np.int16), device).view(torch.bfloat16)
    if dtype_name is not None:
        raise ValueError(f"unsupported stored dtype {dtype_name!r}")
    return from_numpy(arr, device)


def _stored_data(f, info: zipfile.ZipInfo):
    """``(offset, dtype, shape)`` of a stored ``.npy`` member's data in the
    archive ``f``, or None where the member has to go through ``np.load``
    (compressed, Fortran order, an object or big-endian dtype)."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    local = f.read(30)
    if local[:4] != b"PK\x03\x04":
        return None
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    start = info.header_offset + 30 + name_len + extra_len
    f.seek(start)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}.get(
                np.lib.format.read_magic(f))
    if read is None:
        return None
    shape, fortran, dtype = read(f)
    if fortran or dtype.hasobject or dtype.byteorder == ">":
        return None
    offset = f.tell()
    if offset - start + math.prod(shape) * dtype.itemsize != info.file_size:
        return None
    return offset, dtype, shape


def _readinto(f, buf: torch.Tensor) -> None:
    view = memoryview(buf.numpy()).cast("B")
    while len(view):
        n = f.readinto(view)
        if not n:
            raise EOFError("checkpoint member ends early")
        view = view[n:]


def _read_leaf(f, data, dtype_name, device, staging) -> torch.Tensor:
    offset, dtype, shape = data
    if dtype_name == "bfloat16":
        tdtype = torch.bfloat16
    elif dtype_name is not None:
        raise ValueError(f"unsupported stored dtype {dtype_name!r}")
    else:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    out = torch.empty(math.prod(shape) * dtype.itemsize, dtype=torch.uint8,
                      device=device)
    f.seek(offset)
    if device.type == "cpu":
        _readinto(f, out)
    else:
        staging.read(f, out)
    return out.view(tdtype).view(shape)


def load_checkpoint(path: str, like: PyTree, *,
                    device=None) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (shapes validated) on
    ``device`` (``None`` means CUDA).

    ``like``'s leaves only need ``.shape``: ``meta``-device tensors
    (:func:`repro_torch.models.transformer.param_specs`) describe a
    full-width agent stack without allocating it.  Leaves are read from
    the file one at a time, straight into their tensors (through two
    64 MiB pinned buffers for a card).  ``None`` leaves of ``like`` stay
    ``None``.
    """
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = []
    with np.load(path, allow_pickle=False) as z, \
            open(path, "rb", buffering=0) as f:
        meta = json.loads(str(z["__meta__"]))
        dtypes = meta.get("dtypes", {})
        infos = {i.filename[:-4]: i for i in z.zip.infolist()
                 if i.filename.endswith(".npy")}
        staging = _Staging() if dev.type == "cuda" else None
        for p, v in tree_flatten_with_path(like):
            if v is None:
                leaves.append(None)
                continue
            key = _path_str(p)
            if key not in z:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            data = _stored_data(f, infos[key]) if key in infos else None
            arr = z[key] if data is None else None
            shape = data[2] if data else arr.shape
            if hasattr(v, "shape") and tuple(shape) != tuple(v.shape):
                raise ValueError(f"{key}: shape {tuple(shape)} != "
                                 f"{tuple(v.shape)}")
            leaves.append(_to_tensor(arr, dtypes.get(key), dev) if data is None
                          else _read_leaf(f, data, dtypes.get(key), dev,
                                          staging))
        if staging is not None:
            torch.cuda.current_stream(dev).synchronize()
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
