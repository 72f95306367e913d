"""Port parity: ``repro_torch.launch.dryrun`` against ``repro.launch.dryrun``.

The reference's step builders return arguments whose leaves carry
``NamedSharding``s on a mesh of repeated CPU devices (nothing compiled);
the bytes one device holds are the sum of ``shard_shape`` times the
itemsize over them, and the port's dry run must give the same integer for
every arch x input shape x mesh kind.  Input specs, cache specs, the
parameter counts and the analytic flops are held to the reference's; the
agent gathers to one block of the sharded engine on two spawned gloo
ranks."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _dryrun_cases as cases  # noqa: E402
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.api import build  # noqa: E402
from repro_torch.api.spec import AsyncSpec  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.devices()             # the backend exists before the reference's import
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref  # noqa: E402

# the reference's import appends a forced device count to XLA_FLAGS for
# the processes it would start; the running backend ignores it
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = Path(__file__).resolve().parents[1]
SHAPES = sorted(INPUT_SHAPES)


def _ref_mesh(kind: str) -> Mesh:
    """The production mesh's shape over repeated CPU devices."""
    shape, axes = (((16, 16), ("data", "model")) if kind == "single" else
                   ((2, 16, 16), ("pod", "data", "model")))
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


MESHES = {k: _ref_mesh(k) for k in ("single", "multi")}


def _ref_bytes(args) -> int:
    """Sum of shard_shape x itemsize over the reference's arguments (an
    unsharded leaf, the key, is whole on every device)."""
    total = 0
    for leaf in jax.tree.leaves(args):
        shape = (leaf.sharding.shard_shape(leaf.shape)
                 if leaf.sharding is not None else leaf.shape)
        total += int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_args(arch, shape_name, mesh_kind, **kw):
    bundle, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh, multi = MESHES[mesh_kind], mesh_kind == "multi"
    if shape.kind == "train":
        return ref.build_train_step(bundle, shape, mesh, multi, **kw)[1]
    if shape.kind == "prefill":
        return ref.build_prefill_step(bundle, shape, mesh, multi)[1]
    return ref.build_decode_step(bundle, shape, mesh, multi)[1]


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return np.dtype(x).name


# ---------------------------------------------------------------------------
# argument bytes: the parity gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_reference(arch, shape_name, mesh_kind):
    got = dr.dryrun_one(arch, shape_name, mesh_kind)
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == _ref_bytes(
        _ref_args(arch, shape_name, mesh_kind))
    assert sum(mem["argument_parts"].values()) == \
        mem["argument_size_in_bytes"]


#: (flags of dryrun_one, the same for the reference's build_train_step)
OPTIONS = {
    "int8_ef": ({"compress": "int8", "error_feedback": True},
                {"compress": "int8", "error_feedback": True}),
    "topk_diff": ({"compress": "topk", "mix_override": "pallas"},
                  {"compress": "topk", "mix_override": "pallas"}),
    "no_tp": ({"tp": False}, {"tp": False}),
    "link_dropout_corr": (
        {"graph": "link_dropout",
         "graph_kwargs": (("corr", 0.5), ("drop", 0.3))},
        {"graph": "link_dropout",
         "graph_kwargs": (("corr", 0.5), ("drop", 0.3))}),
}


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("option", sorted(OPTIONS) + ["async"])
@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-mistral-7b"])
def test_argument_bytes_under_the_train_options(arch, option, mesh_kind):
    """The communication state (int8 + EF residual, the diff-mode
    reference copy), --no-tp (llava's TP branch of the block rule off), a
    stateful graph and the async engine's buffer, clocks and ages."""
    if option == "async":
        from repro.api.spec import AsyncSpec as RefAsync

        port_kw = {"asynchrony": AsyncSpec(enabled=True)}
        ref_kw = {"asynchrony": RefAsync(enabled=True)}
    else:
        port_kw, ref_kw = OPTIONS[option]
    got = dr.dryrun_one(arch, "train_4k", mesh_kind, **port_kw)
    assert got["memory"]["argument_size_in_bytes"] == _ref_bytes(
        _ref_args(arch, "train_4k", mesh_kind, **ref_kw))
    parts = got["memory"]["argument_parts"]
    if option in ("int8_ef", "topk_diff"):
        assert parts["comm_state"] >= parts["params"]
    if option == "link_dropout_corr":
        assert parts["graph_state"] == 16 * 16 * 4          # replicated
    if option == "async":
        assert got["engine"] == "async" and parts["async_state"] > 0


def test_argument_bytes_of_the_known_combinations():
    """The per-device bytes the reference gives on the single-pod mesh,
    byte for byte."""
    want = {("smollm-360m", "train_4k", ()): 723_773_320,
            ("smollm-360m", "train_4k", (("compress", "int8"),
                                         ("error_feedback", True))):
            1_447_415_560,
            ("mamba2-2.7b", "train_4k", ()): 5_405_320_200,
            ("granite-moe-1b-a400m", "train_4k", ()): 263_495_688,
            ("smollm-360m", "prefill_32k", ()): 45_606_784,
            ("smollm-360m", "decode_32k", ()): 10_782_893_988,
            ("smollm-360m", "long_500k", ()): 66_348_936}
    for (arch, shape, kw), n in want.items():
        got = dr.dryrun_one(arch, shape, "single", **dict(kw))
        assert got["memory"]["argument_size_in_bytes"] == n, (arch, shape)
    parts = dr.dryrun_one("smollm-360m", "train_4k", "single")[
        "memory"]["argument_parts"]
    assert parts == {"params": 723_642_240, "key": 8, "batch": 131_072}


# ---------------------------------------------------------------------------
# input specs, cache specs, counts, flops
# ---------------------------------------------------------------------------

def _same_leaf(port: "dr.Arg", want) -> None:
    assert isinstance(port, dr.Arg) and port.meta.device.type == "meta"
    assert tuple(port.meta.shape) == tuple(want.shape)
    assert _dtype(port.meta.dtype) == _dtype(want.dtype)
    if want.sharding is not None:
        assert tuple(port.spec) == tuple(want.sharding.spec)


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape_name):
    """Shapes, dtypes and partition specs of every input leaf, on the
    single-pod mesh; every leaf on meta."""
    got = dr.input_specs(arch, shape_name)
    want = ref.input_specs(arch, shape_name, mesh=MESHES["single"])
    assert sorted(got) == sorted(want)
    if "cache" in want:
        c = want["cache"]
        port = got.pop("cache")
        wl = jax.tree.leaves(c.segments)
        pl = tree_leaves(port["segments"])
        assert len(pl) == len(wl)
        for p, w in zip(pl, wl):
            _same_leaf(p, w)
        _same_leaf(port["pos"], c.pos)
        _same_leaf(port["slot_pos"], c.slot_pos)
        want = {k: v for k, v in want.items() if k != "cache"}
    flat = {k: v for k, v in got.items() if k != "batch"}
    flat.update(got.get("batch", {}))
    wflat = {k: v for k, v in want.items() if k != "batch"}
    wflat.update(want.get("batch", {}))
    assert sorted(flat) == sorted(wflat)
    for k in wflat:
        _same_leaf(flat[k], wflat[k])


def test_input_specs_no_allocation():
    """The reference's recipe: abstract values only, the block's (T, K,
    B) layout."""
    mesh = dr.MeshShape({"data": 16, "model": 2})
    specs = dr.input_specs("smollm-360m", "train_4k", mesh=mesh)
    for leaf in tree_leaves(specs["batch"]):
        assert isinstance(leaf, dr.Arg) and leaf.meta.device.type == "meta"
    tok = specs["batch"]["tokens"].meta
    assert tok.shape[0] == 4 and tok.shape[1] == 16
    assert tok.shape[1] * tok.shape[2] == 256
    for arch in ("kimi-k2-1t-a32b", "musicgen-medium"):
        for shape in SHAPES:
            for x in tree_leaves(dr.input_specs(arch, shape)):
                assert x.meta.device.type == "meta"


def test_serve_window_rules():
    cfg = port_config("qwen3_32b").model
    assert dr.serve_window(cfg, dr.INPUT_SHAPES["long_500k"]) == 8192
    cfg = port_config("mamba2_2p7b").model
    assert dr.serve_window(cfg, dr.INPUT_SHAPES["long_500k"]) is None
    cfg = port_config("starcoder2_15b").model
    assert dr.serve_window(cfg, dr.INPUT_SHAPES["decode_32k"]) == 4096
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert dr.serve_window(port_config(arch).model,
                                   dr.INPUT_SHAPES[name]) == \
                ref.serve_window(get_config(arch).model, shape)


def test_input_shapes_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in dr.INPUT_SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    port, want = port_config(arch).model, get_config(arch).model
    assert port.total_params() == want.total_params()
    assert port.active_params() == want.active_params()


def test_param_count_keeps_the_reference_approximation():
    """The formula leaves out the norms, as the reference's does."""
    cfg = port_config("smollm-360m").model
    assert cfg.total_params() == 361_758_720
    assert sum(x.numel() for x in tree_leaves(tf.param_specs(cfg))) \
        == 361_821_120


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, shape_name, per_slot):
    cfg, want_cfg = port_config(arch).model, get_config(arch).model
    shape = INPUT_SHAPES[shape_name]
    window = ref.serve_window(want_cfg, shape)
    got = tf.cache_specs(cfg, shape.global_batch, shape.seq_len,
                         window=window, per_slot=per_slot)
    want = ref_tf.cache_specs(want_cfg, shape.global_batch, shape.seq_len,
                              window=window, per_slot=per_slot)
    pl, wl = tree_leaves(list(got.segments)), jax.tree.leaves(want.segments)
    assert len(pl) == len(wl)
    for p, w in zip(pl + [got.slot_pos], wl + [want.slot_pos]):
        assert p.device.type == "meta"
        assert tuple(p.shape) == w.shape and _dtype(p.dtype) == _dtype(
            w.dtype)
    if per_slot:
        assert tuple(got.pos.shape) == want.pos.shape == (shape.global_batch,)
        assert _dtype(got.pos.dtype) == _dtype(want.pos.dtype) == "int32"
    else:                 # the port's whole-batch position is a Python int
        assert got.pos == 0 and want.pos.shape == ()


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_init_cache(arch, per_slot):
    """At smoke size, the specs are what init_cache allocates on the
    CPU."""
    cfg = port_config(arch).smoke
    got = tf.cache_specs(cfg, 2, 48, per_slot=per_slot)
    made = tf.init_cache(cfg, 2, 48, per_slot=per_slot, device="cpu")
    pairs = list(zip(tree_leaves(list(got.segments)),
                     tree_leaves(list(made.segments))))
    pairs.append((got.slot_pos, made.slot_pos))
    if per_slot:
        pairs.append((got.pos, made.pos))
    else:
        assert got.pos == made.pos == 0
    for s, m in pairs:
        assert s.device.type == "meta" and m.device.type == "cpu"
        assert s.shape == m.shape and s.dtype == m.dtype
    assert bool((made.slot_pos == -1).all())


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_equal_the_reference(arch, shape_name):
    from benchmarks.roofline import analytic_flops

    assert dr.analytic_flops(arch, shape_name) == analytic_flops(
        arch, shape_name)
    got = dr.dryrun_one(arch, shape_name, "single")
    assert {k: got[k] for k in ("analytic_flops", "model_flops")} == \
        analytic_flops(arch, shape_name)


def test_analytic_flops_sane():
    """The reference's bounds (tests/test_dryrun_tools.py)."""
    f_train = dr.analytic_flops("smollm_360m", "train_4k")
    assert 3e15 < f_train["model_flops"] < 3e16
    assert f_train["analytic_flops"] >= f_train["model_flops"]
    assert dr.analytic_flops("smollm_360m", "decode_32k")[
        "model_flops"] < 1e13
    assert dr.analytic_flops("mamba2_2p7b", "train_4k")["analytic_flops"] > 0


# ---------------------------------------------------------------------------
# the agent gathers of one block, against two gloo ranks
# ---------------------------------------------------------------------------

GROUP_TIMEOUT_S = 90


def _spawn(world: int, tmp_path, names) -> dict:
    """``_dryrun_cases.worker`` on ``world`` spawned ranks of a gloo group
    (``file://`` rendezvous in ``tmp_path``); every rank killed on a
    timeout."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        cases.worker, args=(world, str(tmp_path / "store"), str(tmp_path),
                            list(names)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo group of {world} did not "
                                   f"finish in {GROUP_TIMEOUT_S}s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return torch.load(tmp_path / "results.pt", weights_only=False)


def test_agent_gathers_equal_one_block_on_two_ranks(tmp_path):
    """Each case's block on two gloo ranks (K = 4, two rows a rank):
    ``AgentShard.wire`` by dtype and the number of gathers equal the dry
    run's count for the same pipeline: the float32 tiles of the kernel
    mixer, the dense mixer's leaves, the fused int8 wire (codes and
    scales a column tile), the generic int8 wire (a leaf at a time) and
    the diff mode's reference copies."""
    results = _spawn(2, tmp_path, cases.CASES)
    for name in cases.CASES:
        spec = cases.spec_of(name)
        eng = build(spec, engine="sharded", device="cpu")
        cfg = port_config(spec.model.arch).smoke
        want = dr.agent_gathers(eng.pipeline, tf.param_specs(cfg),
                                spec.run.num_agents, 2)
        got = results[name]
        assert got["sharded"], name
        assert got["wire"] == want["by_dtype"], name
        assert got["count"] == want["count"], name
        assert want["bytes"] == sum(want["by_dtype"].values()) > 0
    assert set(results["int8_ef"]["wire"]) == {"int8", "float32"}
    assert set(results["pallas"]["wire"]) == {"float32"}


def test_agent_gathers_replicated_and_single_rank():
    """A world that does not divide K, or one rank, gathers nothing."""
    spec = cases.spec_of("pallas")
    eng = build(spec, engine="sharded", device="cpu")
    specs = tf.param_specs(port_config(spec.model.arch).smoke)
    for world in (1, 3):
        assert dr.agent_gathers(eng.pipeline, specs, 4, world)["count"] == 0
    got = dr.dryrun_one("smollm-360m", "train_4k", "single",
                        mix_override="pallas")
    cfg = port_config("smollm-360m").model
    n = sum(x.numel() for x in tree_leaves(tf.param_specs(cfg)))
    assert got["collectives"]["all-gather"]["bytes"] == 16 * n * 4
    assert "no TP all-reduce" in got["collectives"]["tensor_parallel"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

#: the reference's result keys that keep their meaning in the port (XLA's
#: compile_seconds, flops and bytes_accessed have no counterpart)
REF_KEYS = {"arch", "shape", "mesh", "mix", "engine", "graph", "compress",
            "compress_ratio", "error_feedback", "tp", "devices",
            "collectives", "memory", "model_params_total",
            "model_params_active"}


def test_main_writes_the_reference_file_and_keys(tmp_path, capsys):
    dr.main(["--arch", "smollm-360m", "--shape", "train_4k", "--compress",
             "int8", "--error-feedback", "--out", str(tmp_path)])
    path = tmp_path / "smollm-360m_train_4k_single_dense_int8_ef.json"
    res = json.loads(path.read_text())
    assert REF_KEYS <= set(res)
    assert res["devices"] == 256 and res["mix"] == "dense"
    assert res["memory"]["argument_size_in_bytes"] == 1_447_415_560
    assert capsys.readouterr().out.startswith(
        "OK   smollm-360m_train_4k_single_dense_int8_ef:")
    with pytest.raises(ValueError, match="save-hlo"):
        dr.main(["--arch", "smollm-360m", "--shape", "train_4k", "--out",
                 str(tmp_path), "--save-hlo", str(tmp_path / "x.hlo")])


def test_main_all_writes_80_files(tmp_path, capsys):
    dr.main(["--all", "--arch-default-mix", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    want = sorted(f"{a}_{s}_{m}.json" for a in ARCH_IDS for s in SHAPES
                  for m in ("single", "multi"))
    assert names == want
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("OK   ") for line in out) == 80
    with pytest.raises(SystemExit):          # a failed combination
        dr.main(["--arch", "smollm-360m", "--shape", "no_such_shape",
                 "--out", str(tmp_path)])


def test_import_sets_no_environment_and_parses_no_arguments():
    code = ("import os, sys\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert dict(os.environ) == before\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code, "--bogus"],
                          capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
