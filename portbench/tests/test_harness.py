"""The harness: BENCHMARK.json against the cell, configuration, traffic
and metric files; a new cell and a new metric found without editing any
file; no card, no run; and no module of JAX or of the JAX package in a
run, nor of the port in the reference."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from portbench import harness

REPO = harness.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_matches_the_files():
    readers = harness.readers()
    names = {w["name"] for w in BENCH["workloads"]}
    assert names == set(harness.cell_names())
    for w in BENCH["workloads"]:
        cell = json.loads((harness.ROOT / "cells" /
                           f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell.get("chips", 1)) \
            == (w["config"], w["traffic"], w["chips"])
        assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                       "launches_off"}
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    for kind, group in (("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        for m in BENCH[group]:
            mod = readers[m["name"]]
            assert (mod.KIND, mod.UNIT) == (kind, m["unit"])
    assert {m["name"] for m in BENCH["end_to_end"]} | \
        {m["name"] for m in BENCH["per_layer"]} == set(readers)


def test_benchmark_json_keeps_the_contract_forms():
    import re

    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and all(name.match(k)
                                             for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert name.match(m["name"]) and unit.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            if group == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
                assert 1 <= len(m["layer"]) <= 200


def test_configs_are_the_published_configs_but_for_the_reduced_keys():
    """Each file's model against the source's published values, which the
    file lists under ``published`` ({key: [the source's key, value]}):
    equal but for the keys in ``reduced``, each of which differs and has
    its reason under ``deviations``.  A key the source does not give is
    under ``assumed``."""
    for c in BENCH["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        model, published = config["model"], config["published"]
        assert set(model) - {"name", "family"} == \
            set(published) | (set(model) & set(config["assumed"]))
        assert not set(published) & set(config["assumed"])
        assert set(config["deviations"]) == set(config["reduced"])
        for key, (source_key, value) in published.items():
            assert source_key
            if key in config["reduced"]:
                assert model[key] != value, key
            else:
                assert model[key] == value, key
        assert model["num_layers"] < published["num_layers"][1]
    for name in harness.cell_names():
        cell = harness.load_cell(name)
        assert cell["traffic"].get("image_positions", 0) == \
            cell["config"]["model"].get("img_tokens", 0)


def test_the_configs_run_in_the_port():
    """The port builds each model as the file states it (every key a field
    of its ``ModelConfig``), and its kernels take the cell's shapes."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ssd_scan

    for name in harness.cell_names():
        cell = harness.load_cell(name)
        cfg = ModelConfig(**cell["config"]["model"], use_kernels=True)
        if cfg.ssm_state:
            assert cfg.ssm_chunk in ssd_scan.CHUNKS
            assert cell["traffic"]["seq"] % cfg.ssm_chunk == 0


def test_a_new_cell_and_metric_are_found_without_edits(smoke):
    """Files added beside the others, and nothing edited: the new cell
    runs (on the CPU, as the tests do) and its line carries the new
    metric."""
    (smoke / "metrics" / "blocks_seen.py").write_text(textwrap.dedent('''
        KIND = "end_to_end"
        UNIT = "blocks"

        def read(run):
            return run["window"]["blocks"]
    '''))
    base = json.loads((smoke / "cells" /
                       "mamba2-2.7b.train.k4-q09.smoke.json").read_text())
    traffic = json.loads((smoke / "traffic" /
                          "mamba2-2.7b.train.k4-q09.smoke.json").read_text())
    traffic.update(agents=3, mask_seed=5)
    (smoke / "traffic" / "k3.json").write_text(json.dumps(traffic))
    (smoke / "cells" / "new.k3.json").write_text(
        json.dumps(dict(base, traffic="k3")))
    assert "new.k3" in harness.cell_names(smoke)
    assert "blocks_seen" in harness.readers(smoke)
    run = harness.run_cell("new.k3", 3, 0.5, False, device="cpu",
                           t_start=0.0, root=smoke)
    line = harness.result_line(run, False, smoke, device="cpu")
    assert line["correct"]
    assert line["metrics"]["blocks_seen"]["value"] >= 1
    assert list(line)[-1] == "checks"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-2.7b.train.k4-q09", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_no_reference_package_no_port_in_the_reference():
    """By the sources (whole top-level names: ``repro_torch`` is not
    ``repro``), and in a subprocess that imports every module of the
    benchmark and the port."""
    for path in harness.ROOT.rglob("*.py"):
        tops = _imports(path)
        assert not tops & set(harness.FORBIDDEN), path
        assert "benchmarks" not in tops, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
    code = textwrap.dedent('''
        import importlib, sys
        sys.path[:0] = [{repo!r}, {src!r}]
        for name in ("common", "mamba2", "mistral"):
            importlib.import_module("portbench.reference." + name)
        held = [m for m in sys.modules
                if m.split(".")[0] in ("repro_torch", "repro", "jax")]
        assert not held, held
        from portbench import harness
        for name in ("compare", "counts", "trace", "traffic",
                     "kinds.train"):
            importlib.import_module("portbench." + name)
        harness.readers()
        import repro_torch.api, repro_torch.launch.train
        found = harness.forbidden_modules()
        assert not found, found
    ''').format(repo=str(REPO), src=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr


def _ranges(K=4, L=3, T=2, masks=((1, 1, 0, 1), (0, 0, 0, 0), (1, 0, 1, 0))):
    import numpy as np

    from portbench.kinds import train

    traffic = {"agents": K, "local_steps": T, "mixer": "pallas",
               "topology": "ring"}
    model = {"num_layers": L, "ssm_state": 16}
    return train, train.launch_ranges(model, traffic,
                                      np.array(masks, dtype=np.float32))


def test_launch_ranges_admit_any_layout_of_the_work():
    """The path check holds the program to having run the cell's kernels,
    not to one layout of their launches: every agent computed (today's
    program), inactive agents skipped, agents batched into one launch a
    layer and step, a combination tiled any way all pass."""
    train, ranges = _ranges()
    assert ranges["ssd_intra_chunk"] == (3 * 2 * 2, 3 * 4 * 2 * 3)
    # agents 0 and 2 active in a ring of 4 are not neighbours: the third
    # block's realized matrix is the identity
    assert ranges["diffusion_mix"] == (1, None)
    assert ranges["flash_attention"] == (0, 0)
    base = dict.fromkeys(ranges, 0)
    for ssd, mix in ((24 * 3, 22 * 3), (3 * 2 * 5, 66), (3 * 2 * 2, 1),
                     (24 * 3, 3 * 500)):
        assert train.launches_off(dict(base, ssd_intra_chunk=ssd,
                                       diffusion_mix=mix), ranges) == 0


def test_launch_ranges_catch_a_path_that_did_not_run():
    train, ranges = _ranges()
    base = dict.fromkeys(ranges, 0)
    good = dict(base, ssd_intra_chunk=72, diffusion_mix=66)
    assert train.launches_off(good, ranges) == 0
    for bad in (dict(good, ssd_intra_chunk=0), dict(good, diffusion_mix=0),
                dict(good, ssd_intra_chunk=73),
                dict(good, flash_attention=1), dict(good, gather_mix=3)):
        assert train.launches_off(bad, ranges) == 1
