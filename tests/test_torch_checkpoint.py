"""Port parity: npz checkpoints cross-load between ``repro.checkpoint`` and
``repro_torch.checkpoint`` in both directions, bf16 leaves bit-equal."""
import json
import zipfile

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint, load_meta,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.store import _stored_data  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _ref_tree():
    rng = np.random.default_rng(0)
    return {"embed": jnp.asarray(rng.standard_normal((4, 9, 6)),
                                 jnp.bfloat16),
            "segments": {"00.attn.002": {
                "ln1": {"scale": jnp.asarray(rng.standard_normal((4, 2, 6)),
                                             jnp.float32)},
                "count": jnp.arange(8, dtype=jnp.int32).reshape(4, 2)}},
            "final_norm": {"scale": jnp.asarray(rng.standard_normal((4, 6)),
                                                jnp.bfloat16)}}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_reference_archive_loads_into_port_bit_equal(tmp_path):
    tree = _ref_tree()
    path = str(tmp_path / "ref.npz")
    ref_save(path, tree, step=7, metadata={"note": "x"})
    like = params_from_jax(jax.device_get(tree), device="meta")
    got, meta = load_checkpoint(path, like, device="cpu")
    assert meta["step"] == 7 and meta["note"] == "x"
    assert meta == load_meta(path)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(tree)):
        if np.asarray(w).dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_numpy(g), _bits(w))


def test_port_archive_loads_into_reference_bit_equal(tmp_path):
    tree = _ref_tree()
    port = params_from_jax(jax.device_get(tree), device="cpu")
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, port, step=3)
    like = jax.tree.map(jnp.zeros_like, tree)
    got, meta = ref_load(path, like)
    assert meta["step"] == 3
    assert meta["dtypes"] == {"embed": "bfloat16",
                              "final_norm/scale": "bfloat16"}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the two writers produce the same archive layout
    ref_path = str(tmp_path / "ref.npz")
    ref_save(ref_path, tree, step=3)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__meta__"])) == json.loads(
            str(b["__meta__"]))
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


def test_load_validates_structure(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.zeros(3, 2)}, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(path, {"b": torch.zeros(2, 3)}, device="cpu")
    got, _ = load_checkpoint(path[:-4], {"a": torch.zeros(2, 3)},
                             device="cpu")
    assert torch.equal(got["a"], torch.zeros(2, 3))


def _odd_tree():
    rng = np.random.default_rng(1)
    return {"bf16": torch.as_tensor(rng.standard_normal((3, 5)),
                                    dtype=torch.float32).to(torch.bfloat16),
            "f16": torch.as_tensor(rng.standard_normal(7)).half(),
            "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "mask": torch.as_tensor([True, False, True]),
            "step": torch.tensor(5, dtype=torch.int32),
            "empty": torch.zeros((0, 4)),
            "host": np.arange(4, dtype=np.float64)}


def test_streamed_archive_equals_savez_and_round_trips(tmp_path):
    tree = _odd_tree()
    path = str(tmp_path / "s")                    # np.savez adds .npz
    save_checkpoint(path, tree, step=2)
    arrays, dtypes = {}, {}
    for k, v in tree.items():
        arr = to_numpy(v) if isinstance(v, torch.Tensor) else v
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            arr, dtypes[k] = arr.view("V2"), "bfloat16"
        arrays[k] = arr
    ref_path = str(tmp_path / "ref.npz")
    np.savez(ref_path, __meta__=json.dumps(
        {"step": 2, "keys": sorted(arrays), "dtypes": dtypes}), **arrays)
    with np.load(path + ".npz") as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
    # every member of either archive is read in place, not through np.load
    for name in (path + ".npz", ref_path):
        with zipfile.ZipFile(name) as z, open(name, "rb") as f:
            assert all(_stored_data(f, i) is not None for i in z.infolist()
                       if i.filename != "__meta__.npy")
    got, meta = load_checkpoint(path, tree, device="cpu")
    assert meta["step"] == 2
    for k, v in tree.items():
        want = torch.as_tensor(v)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert torch.equal(got[k], want)


@pytest.mark.parametrize("layout", ["compressed", "fortran"])
def test_members_np_load_must_read_still_load(tmp_path, layout):
    """A compressed or Fortran-ordered member goes through np.load."""
    rng = np.random.default_rng(2)
    arr = np.asfortranarray(rng.standard_normal((4, 3)).astype(np.float32))
    bits = rng.integers(-2**15, 2**15, (2, 3), dtype=np.int16)
    path = str(tmp_path / "c.npz")
    save = np.savez_compressed if layout == "compressed" else np.savez
    save(path, __meta__=json.dumps({"step": 1, "keys": ["a", "b"],
                                    "dtypes": {"b": "bfloat16"}}),
         a=arr, b=bits.view("V2"))
    like = {"a": torch.zeros(4, 3), "b": torch.zeros(2, 3)}
    got, _ = load_checkpoint(path, like, device="cpu")
    assert torch.equal(got["a"], torch.as_tensor(np.ascontiguousarray(arr)))
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"].view(torch.int16), torch.as_tensor(bits))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.zeros(3, 4), "b": like["b"]},
                        device="cpu")


def _member_start(path: str, name: str) -> tuple[int, zipfile.ZipInfo]:
    """Where member ``name``'s bytes (its .npy magic) start in the file."""
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(name)
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), "<u2")
    return info.header_offset + 30 + int(name_len) + int(extra_len), info


def _flip(path: str, where: int, out: str) -> str:
    raw = bytearray(open(path, "rb").read())
    raw[where] ^= 0x10
    with open(out, "wb") as f:
        f.write(raw)
    return out


@pytest.mark.parametrize("where", ["data", "header"])
def test_flipped_byte_raises_bad_zip_file(tmp_path, where):
    """The streamed load checks each member's CRC-32 as np.load does: one
    flipped byte in a member's data or in its .npy header raises
    BadZipFile naming the member; the unflipped file loads bit-equal."""
    tree = {"w": torch.randn(4096), "b": torch.randn(3, 5).to(torch.bfloat16)}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tree)
    start, info = _member_start(path, "w.npy")
    at = start + info.file_size - 100 if where == "data" else start + 20
    bad = _flip(path, at, str(tmp_path / "bad.npz"))
    if where == "data":              # numpy's parser meets a bad header first
        with pytest.raises(zipfile.BadZipFile, match="'w.npy'"):
            np.load(bad)["w"]                   # the reference's reader
    with pytest.raises(zipfile.BadZipFile, match="Bad CRC-32 for file "
                                                 "'w.npy'"):
        load_checkpoint(bad, tree, device="cpu")
    got, _ = load_checkpoint(path, tree, device="cpu")
    assert all(torch.equal(got[k], tree[k]) for k in tree)


def test_every_flipped_header_byte_raises(tmp_path):
    """A flip anywhere in the magic, the version, the header length or the
    header text raises BadZipFile, whatever numpy's parser would say."""
    path = str(tmp_path / "c.npz")
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    save_checkpoint(path, tree)
    start, _ = _member_start(path, "w.npy")
    bad = str(tmp_path / "bad.npz")
    for at in range(start, start + 128):
        with pytest.raises(zipfile.BadZipFile):
            load_checkpoint(_flip(path, at, bad), tree, device="cpu")


def test_flipped_byte_in_a_member_np_load_reads_raises(tmp_path):
    """A Fortran-ordered member goes through np.load, whose zipfile read
    makes the check."""
    arr = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(4, 3))
    path = str(tmp_path / "c.npz")
    np.savez(path, __meta__=json.dumps({"step": 0, "keys": ["a"],
                                        "dtypes": {}}), a=arr)
    start, info = _member_start(path, "a.npy")
    bad = _flip(path, start + info.file_size - 4, str(tmp_path / "b.npz"))
    with pytest.raises(zipfile.BadZipFile, match="'a.npy'"):
        load_checkpoint(bad, {"a": torch.zeros(4, 3)}, device="cpu")


def test_crc_over_many_pieces(tmp_path, monkeypatch):
    """With pieces of a few bytes every member is read and hashed in many
    pieces, joined by crc32_combine: the load is bit-equal and a flip in
    the last piece still raises."""
    from repro_torch.checkpoint import store

    monkeypatch.setattr(store, "_CHUNK", 4096)
    monkeypatch.setattr(store, "_HASH_PIECE", 1000)
    tree = {"a": torch.randn(10_001), "b": torch.randn(3, 333).half()}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tree)
    got, _ = load_checkpoint(path, tree, device="cpu")
    assert all(torch.equal(got[k], tree[k]) for k in tree)
    start, info = _member_start(path, "a.npy")
    bad = _flip(path, start + info.file_size - 1, str(tmp_path / "b.npz"))
    with pytest.raises(zipfile.BadZipFile, match="'a.npy'"):
        load_checkpoint(bad, tree, device="cpu")


def test_crc32_combine_equals_zlib():
    import zlib

    from repro_torch.checkpoint.store import crc32_combine

    rng = np.random.default_rng(3)
    for n1, n2 in [(0, 0), (0, 7), (5, 0), (1, 1), (100, 4096),
                   (3, 1 << 20), (65_537, 12_345)]:
        a = rng.integers(0, 256, n1, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n2, dtype=np.uint8).tobytes()
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), n2) \
            == zlib.crc32(a + b)
