"""The benchmark's harness: finds a cell's files by name, runs it once, and
prints the result.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own under this folder, found by name:

* ``cells/<workload>.json``: the configuration and the traffic it pairs,
  and the limit of each number the comparison checks;
* ``configs/<config>.json``: the model as it is run (``model``: the port's
  ``ModelConfig`` fields), its reference ``family``
  (``reference/<family>.py``), the port's arch it stands for and the
  kernel sources its path builds;
* ``traffic/<traffic>.json``: the parameters the generator
  (:mod:`portbench.traffic`) reads, and the ``kind`` that drives it
  (``kinds/<kind>.py``);
* ``metrics/<metric>.py``: one reader each (``KIND``, ``UNIT``,
  ``read(run) -> float | None``); a reader that finds nothing to read
  returns None and the metric is left out of the line.

A run needs a CUDA card and never falls back to the CPU; it fails if the
process holds a module of JAX or of the JAX package once the window has
closed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

__all__ = ["ROOT", "load_cell", "cell_names", "readers", "run_cell",
           "result_line", "forbidden_modules", "main", "NoCard"]

ROOT = Path(__file__).resolve().parent
#: top-level modules a run must not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the cores a run is held to (the last of those the process may use)
PIN_CORES = 2


class NoCard(RuntimeError):
    """The machine has fewer CUDA cards than the cell asks for."""


def _load(root: Path, folder: str, name: str) -> dict:
    path = root / folder / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"{name!r}: no file {path}")
    return json.loads(path.read_text())


def cell_names(root: Path = ROOT) -> list[str]:
    return sorted(p.stem for p in (root / "cells").glob("*.json"))


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic loaded."""
    cell = _load(root, "cells", name)
    return dict(cell, name=name,
                config=dict(_load(root, "configs", cell["config"]),
                            name=cell["config"]),
                traffic=dict(_load(root, "traffic", cell["traffic"]),
                             name=cell["traffic"]))


def readers(root: Path = ROOT) -> dict:
    """{metric name: reader module} of every ``metrics/*.py``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a run must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell "
                     f"asks for {chips}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float, root: Path = ROOT
             ) -> dict:
    """One run of cell ``name``: the kind's run dict (what the metric
    readers read)."""
    cell = load_cell(name, root)
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    return kind.run(cell, seed, seconds, trace, device, t_start)


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def result_line(run: dict, trace: bool, root: Path = ROOT,
                device: str = "cuda") -> dict:
    """The result's JSON object; ``checks`` comes last."""
    import torch

    from portbench import compare

    want = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, mod in readers(root).items():
        if mod.KIND != want:
            continue
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(run["peak_bytes"])}
    if cuda:
        dev["power_limit"] = power_limit()
    line = {"correct": compare.passes(run["checks"]),
            "attempted": int(run["attempted"]), "failed": 0,
            "metrics": metrics, "device": dev}
    traced = run.get("trace")
    if trace and traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        line["breakdown"] = {"device_ops": traced["device_ops"],
                             "idle_gaps": traced["idle_gaps"]}
    line["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"])
                          else str(c["value"]), "limit": c["limit"]}
                      for n, c in run["checks"].items()}
    return line


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    try:
        check_card(cell.get("chips", 1))
    except NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    import torch

    # one process with one host thread for the program's few CPU
    # operations: its dispatch of the card's work is what the host does.
    # The process stays on two fixed cores of those it may use (the main
    # thread and the CUDA runtime's own), which keeps the host's dispatch
    # from moving between cores
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-PIN_CORES:])
    torch.set_num_threads(1)
    run = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=t_start)
    line = result_line(run, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run holds modules of {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 4
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0
