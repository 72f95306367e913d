"""The readings a cell's limits are set from, on the card at the cell's own
size: the numbers the comparison checks, for the program on each seed of
``--seeds``, and for the control (the reference computed in fp8) and the
faults planted in the reference (half of the batch left out, the
exchange left out) on each seed of ``--control-seeds``.  No window runs:
training's readings need none.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --out calibrate.jsonl

Each seed's readings are one JSON line (printed, and appended to
``--out``); the last line gives, for each number, the largest program
reading and the smallest reading of the control and of each fault.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from portbench import harness  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    harness.check_card(cell.get("chips", 1))
    print(f"card: {torch.cuda.get_device_name()}, power limit "
          f"{harness.power_limit()}", flush=True)
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        row = kind.readings(cell, seed, "cuda",
                            controls=seed in args.control_seeds)
        row = {"seed": seed, "seconds": time.perf_counter() - t0, **row,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        rows.append(row)
        text = json.dumps(row)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    summary = {"workload": args.workload, "seeds": len(rows)}
    for name in ("loss_gap", "grad_gap", "change_gap"):
        summary[name] = {"program_max": max(r["program"][name]
                                            for r in rows)}
        for what in ("control_fp8", "half_batch", "no_exchange"):
            got = [r[what][name] for r in rows if what in r]
            if got:
                summary[name][f"{what}_min"] = min(got)
    text = json.dumps(summary)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
