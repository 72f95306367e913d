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
copied to the card.  As ``zipfile`` does, the load checks each member's
CRC-32 (its ``.npy`` header and data) and raises ``zipfile.BadZipFile``
on a mismatch: the pieces are hashed on a few threads while the next one
is read (``zlib.crc32`` releases the GIL), the hashes joined by
:func:`crc32_combine`, and a staging buffer is refilled only after both
its copy to the card and its hash have ended.  A compressed,
Fortran-ordered or big-endian member goes through ``np.load``, whose
``zipfile`` read makes the same check.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import tokenize
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.convert import from_numpy, to_numpy
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

PyTree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "load_meta",
           "save_experiment", "load_spec", "load_experiment",
           "crc32_combine"]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


_CHUNK = 64 << 20        # bytes a write or a staged copy moves at a time
_HASH_PIECE = 16 << 20   # bytes one CRC-32 task hashes
_HASHERS = 8             # threads hashing while the next piece is read

_CRC_POLY = 0xEDB88320   # the reflected CRC-32 polynomial (zlib's)


def _multmodp(a: int, b: int) -> int:
    """a(x) b(x) modulo the CRC-32 polynomial, bit-reflected (zlib's
    ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if a & (m - 1) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


#: x^(2^k) modulo the polynomial, k = 0..31
_X2N = [1 << 30]
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``a + b`` from ``crc1 = crc32(a)``, ``crc2 =
    crc32(b)`` and ``len2 = len(b)`` (zlib's ``crc32_combine``: ``crc1``
    times x^(8 len2) modulo the polynomial, plus ``crc2``)."""
    p, k = 1 << 31, 3                    # x^0; 8 len2 = len2 << 3
    while len2:
        if len2 & 1:
            p = _multmodp(_X2N[k & 31], p)
        len2 >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


class _MemberCrc:
    """The CRC-32 of one stored member, as ``zipfile`` checks it: the
    ``.npy`` header bytes, then the data, hashed in pieces on ``pool``
    while the next piece is read."""

    def __init__(self, pool: ThreadPoolExecutor, info: zipfile.ZipInfo,
                 head: bytes):
        self.pool, self.info = pool, info
        self.head = zlib.crc32(head)
        self.parts = []                  # (future of a piece's CRC, length)

    def hash(self, view: memoryview) -> list:
        """Queue the member's next bytes; returns the futures reading
        ``view``, which must not change before they end."""
        futures = []
        for i in range(0, len(view), _HASH_PIECE):
            piece = view[i:i + _HASH_PIECE]
            futures.append(self.pool.submit(zlib.crc32, piece))
            self.parts.append((futures[-1], len(piece)))
        return futures

    def check(self) -> None:
        crc = self.head
        for future, n in self.parts:
            crc = crc32_combine(crc, future.result(), n)
        if crc != self.info.CRC:
            raise zipfile.BadZipFile(
                f"Bad CRC-32 for file {self.info.filename!r}")


class _Staging:
    """Two pinned 64 MiB host buffers taking turns between the file and a
    card: one is filled (or written out) while the other's copy runs.  On
    a load a buffer is refilled only after its copy to the card and its
    CRC-32 hash have both ended."""

    def __init__(self):
        self.bufs = [torch.empty(_CHUNK, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.done = [torch.cuda.Event(), torch.cuda.Event()]
        self.hashing = [[], []]          # futures still reading each buffer
        self.turn = 0

    def _next(self):
        k = self.turn
        self.turn ^= 1
        return k, self.bufs[k], self.done[k]

    def read(self, f, out: torch.Tensor, crc: _MemberCrc) -> None:
        """The next ``out.numel()`` bytes of ``f`` into ``out`` (uint8,
        on a card), each piece hashed into ``crc``."""
        for i in range(0, out.numel(), _CHUNK):
            n = min(_CHUNK, out.numel() - i)
            k, buf, done = self._next()
            done.synchronize()               # its previous copy has ended
            wait(self.hashing[k])            # and so has its hash
            view = memoryview(buf[:n].numpy())
            _readinto(f, view)
            out[i:i + n].copy_(buf[:n], non_blocking=True)
            done.record()
            self.hashing[k] = crc.hash(view)

    def write(self, fid, data: torch.Tensor) -> None:
        """``data`` (uint8, on a card) to ``fid``: chunk i+1's copy to the
        host runs while chunk i is written."""
        held = None
        for i in range(0, data.numel(), _CHUNK):
            n = min(_CHUNK, data.numel() - i)
            _, buf, done = self._next()
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
    """``(offset, dtype, shape, head)`` of a stored ``.npy`` member of the
    archive ``f``: where its data starts, its dtype and shape, and the
    bytes before the data (the ``.npy`` magic and header, which the
    member's CRC-32 covers); or None where the member has to go through
    ``np.load`` (compressed, Fortran order, an object or big-endian
    dtype).  A header that does not parse, or does not fit the member's
    size, is checked against the CRC first: a damaged one raises
    ``zipfile.BadZipFile``."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    local = f.read(30)
    if local[:4] != b"PK\x03\x04":
        return None
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    start = info.header_offset + 30 + name_len + extra_len
    f.seek(start)
    try:
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(
                    np.lib.format.read_magic(f))
        shape, fortran, dtype = read(f) if read else (None, None, None)
    except (ValueError, TypeError, SyntaxError, tokenize.TokenError):
        read = None                      # what numpy raises on a bad header
    offset = f.tell()
    if read is None or offset - start + math.prod(shape) * dtype.itemsize \
            != info.file_size:
        _check_whole(f, start, info)
        return None
    if fortran or dtype.hasobject or dtype.byteorder == ">":
        return None
    f.seek(start)
    return offset, dtype, shape, f.read(offset - start)


def _check_whole(f, start: int, info: zipfile.ZipInfo) -> None:
    """Raise ``zipfile.BadZipFile`` unless the ``info.file_size`` bytes of
    ``f`` from ``start`` have the member's CRC-32."""
    f.seek(start)
    crc, left = 0, info.file_size
    while left:
        piece = f.read(min(left, _CHUNK))
        if not piece:
            break
        crc, left = zlib.crc32(piece, crc), left - len(piece)
    if left or crc != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")


def _readinto(f, view: memoryview) -> None:
    view = view.cast("B")
    while len(view):
        n = f.readinto(view)
        if not n:
            raise EOFError("checkpoint member ends early")
        view = view[n:]


def _read_leaf(f, data, crc: _MemberCrc, dtype_name, device,
               staging) -> torch.Tensor:
    offset, dtype, shape, _ = data
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
        view = memoryview(out.numpy())
        for i in range(0, len(view), _CHUNK):
            _readinto(f, view[i:i + _CHUNK])
            crc.hash(view[i:i + _CHUNK])
    else:
        staging.read(f, out, crc)
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
    ``None``.  A member whose CRC-32 does not match raises
    ``zipfile.BadZipFile``, as ``np.load`` does.
    """
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves, crcs = [], []
    with np.load(path, allow_pickle=False) as z, \
            open(path, "rb", buffering=0) as f, \
            ThreadPoolExecutor(_HASHERS, thread_name_prefix="crc32") as pool:
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
            if data is None:
                leaves.append(_to_tensor(arr, dtypes.get(key), dev))
                continue
            crcs.append(_MemberCrc(pool, infos[key], data[3]))
            leaves.append(_read_leaf(f, data, crcs[-1], dtypes.get(key),
                                     dev, staging))
        for crc in crcs:
            crc.check()
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
