"""Port parity: npz checkpoints cross-load between ``repro.checkpoint`` and
``repro_torch.checkpoint`` in both directions, bf16 leaves bit-equal."""
import json

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
