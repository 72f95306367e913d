"""Port parity: the sharding rules.

``repro_torch.sharding.rules`` against ``repro.sharding.rules``, spec for
spec, on the reference's fake meshes (a (4, 2) ``data, model`` mesh and a
(2, 16, 16) ``pod, data, model`` one, over the one CPU device repeated)
and the parameter trees of the archs the port has, at smoke and full size.
The port's rules take the JAX mesh directly (its ``shape`` maps axis names
to sizes) and a ``DeviceMesh``-shaped stand-in (``mesh_dim_names`` and a
``shape`` tuple)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402


def _fake_mesh(shape, axes):
    """The reference tests' abstract mesh: the one real device, repeated."""
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


MESHES = {"data4_model2": _fake_mesh((4, 2), ("data", "model")),
          "pod2_data16_model16": _fake_mesh((2, 16, 16),
                                            ("pod", "data", "model"))}
ARCHS = ("smollm-360m", "mamba2-2.7b", "zamba2-1.2b", "chatglm3-6b",
         "qwen3-32b", "starcoder2-15b", "granite-moe-1b-a400m",
         "kimi-k2-1t-a32b", "llava-next-mistral-7b", "musicgen-medium")


class _DeviceMeshLike:
    """What the rules read from a ``torch.distributed`` ``DeviceMesh``."""

    def __init__(self, jax_mesh):
        self.mesh_dim_names = tuple(jax_mesh.axis_names)
        self.shape = tuple(jax_mesh.shape[a] for a in jax_mesh.axis_names)


def _ref_flat(tree):
    """[(path, spec tuple)] of a reference PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                      for e in p), tuple(v)) for p, v in flat]


def _port_flat(tree):
    return [("/".join(str(k) for k in p), tuple(v))
            for p, v in tree_flatten_with_path(tree)]


def _trees(arch: str, smoke: bool):
    ref_b, b = ref_get_config(arch), get_config(arch)
    ref_cfg = ref_b.smoke if smoke else ref_b.model
    cfg = b.smoke if smoke else b.model
    return ref_tf.param_specs(ref_cfg), tf.param_specs(cfg)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch, smoke, mesh_name):
    """Every leaf's spec, for fsdp on/off and tp on/off, and with the agent
    axis prepended, equals the reference's entry for entry (paths too)."""
    mesh = MESHES[mesh_name]
    ref_tree, tree = _trees(arch, smoke)
    for kw in ({}, {"fsdp": True}, {"tp": False},
               {"fsdp": True, "tp": False}):
        want = ref_rules.param_pspecs(ref_tree, mesh, **kw)
        for m in (mesh, _DeviceMeshLike(mesh)):
            got = rules.param_pspecs(tree, m, **kw)
            assert _port_flat(got) == _ref_flat(want), kw
        for axis in ("data", None):
            assert (_port_flat(rules.add_agent_axis(got, axis))
                    == _ref_flat(ref_rules.add_agent_axis(want, axis)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_agent_batch_and_serve_specs_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    like = _DeviceMeshLike(mesh)
    for K in (1, 2, 3, 4, 6, 8, 16, 32, 1024):
        for axis in ("data", "pod", "model", "absent", None):
            for ndim in (1, 2, 4):
                want = tuple(ref_rules.agent_stack_pspec(
                    mesh, axis, num_agents=K, ndim=ndim))
                for m in (mesh, like):
                    assert tuple(rules.agent_stack_pspec(
                        m, axis, num_agents=K, ndim=ndim)) == want
    for axis in ("data", "pod", None):
        for ndim in (3, 4, 5):
            for lead in (True, False):
                for tp in (True, False):
                    for batch in (None, 1, 2, 3, 8, 64, 512):
                        want = tuple(ref_rules.batch_pspec(
                            mesh, agent_axis=axis, ndim=ndim,
                            leading_T=lead, tp=tp, batch=batch))
                        got = rules.batch_pspec(
                            like, agent_axis=axis, ndim=ndim,
                            leading_T=lead, tp=tp, batch=batch)
                        assert tuple(got) == want
    for batch in (1, 2, 4, 6, 32, 64):
        for ndim in (1, 2, 3):
            assert (tuple(rules.serve_batch_pspec(like, batch, ndim))
                    == tuple(ref_rules.serve_batch_pspec(mesh, batch, ndim)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 4, 32, 64])
def test_cache_pspecs_equal_the_reference(mesh_name, batch):
    """KV, SSM and conv cache leaves (and an unknown leaf) under every
    batch-sharding case."""
    mesh = MESHES[mesh_name]
    shapes = {"layers": {"k": (4, batch, 256, 8, 64),
                         "v": (4, batch, 256, 8, 64),
                         "ssm": (2, batch, 32, 64, 16),
                         "conv": (2, batch, 3, 96),
                         "pos": (batch,)},
              "odd": {"k": (4, batch, 100, 5, 64),
                      "ssm": (2, batch, 15, 64, 16)}}
    ref_tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))
    tree = {g: {n: torch.empty(s, device="meta") for n, s in d.items()}
            for g, d in shapes.items()}
    want = _ref_flat(ref_rules.cache_pspecs(ref_tree, mesh, batch))
    for m in (mesh, _DeviceMeshLike(mesh)):
        assert _port_flat(rules.cache_pspecs(tree, m, batch)) == want


def test_divisibility_guard_on_the_full_width_trees():
    """The reference's own guard test, on every arch the port has: every
    sharded dim divides its axis size (smollm's 15 heads do not divide
    the model axis of 2, so those dims stay replicated)."""
    mesh = MESHES["data4_model2"]
    sizes = rules.axis_sizes(mesh)
    for arch in ARCHS:
        _, tree = _trees(arch, smoke=False)
        ps = rules.param_pspecs(tree, mesh, fsdp=True)
        for leaf, spec in zip(tree_leaves(tree), tree_leaves(ps)):
            for dim, axis in zip(leaf.shape, tuple(spec)):
                if axis is not None:
                    size = (sizes[axis] if isinstance(axis, str)
                            else int(np.prod([sizes[a] for a in axis])))
                    assert dim % size == 0, (arch, leaf.shape, spec)


def test_named_maps_specs_onto_device_mesh_placements():
    """``named``: one placement per mesh dim, Shard(d) where tensor dim d
    names that mesh dim (a composite entry shards every axis it names on
    the same tensor dim), Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    like = _DeviceMeshLike(MESHES["pod2_data16_model16"])
    tree = {"a": rules.P("data", None), "b": rules.P(None, ("pod", "data"),
                                                     "model"),
            "c": rules.P(None, None)}
    got = rules.named(tree, like)
    assert got["a"] == (Replicate(), Shard(0), Replicate())
    assert got["b"] == (Shard(1), Shard(1), Shard(2))
    assert got["c"] == (Replicate(), Replicate(), Replicate())
    # a whole parameter tree keeps its structure, a placement tuple a leaf
    _, params = _trees("smollm-360m", smoke=True)
    placed = rules.named(rules.param_pspecs(params, like), like)
    assert len(tree_flatten_with_path(placed)) == 3 * len(tree_leaves(
        params))


def test_axis_sizes_refuses_a_mesh_without_names():
    class Bare:
        shape = (4, 2)

    with pytest.raises(TypeError, match="axis sizes"):
        rules.axis_sizes(Bare())
