#!/usr/bin/env python3
"""A benchmark cell's traced run, with its program spans laid on the
profiler's timeline.

  python3 tools/span_report.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``portbench/run.py ... --trace 1`` does (and prints the
same result line), then reads the port's span store
(:mod:`repro_torch.spans`) against the profiles of the traced blocks and
prints one JSON line (``span_report {...}``):

* ``calls``: the stored spans of each name over the traced blocks;
* ``cover``: host seconds a block traced with the device's activity
  alone of ``engine.local_updates`` and of the spans under it, and the
  share of it that ``local.forward``, ``local.backward`` and
  ``local.update`` cover;
* ``idle``: the device's idle seconds of the host-traced block (and of
  the blocks traced with the device alone), each gap put down to the
  innermost program span containing its midpoint, with the share that
  lies in a span at sub-layer depth (:data:`SUBLAYER`);
* ``clock``: over every span of the host-traced block, the store's start
  less the start of the profile's ``record_function`` event of the same
  span (ns: median, 95th percentile, largest in size);
* ``annotation``: whether the trace's events have ``is_user_annotation``
  (which ``portbench/trace.py`` uses to leave the ranges' device-side
  copies out of the busy time), and whether any device event carrying a
  span's name reads as busy.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import trace as trace_lib  # noqa: E402

#: spans at sub-layer depth: a model sub-layer forward or backward, the
#: optimizer update, the prologue, a combination stage
SUBLAYER = re.compile(r"model\.|local\.update$|engine\.prologue$|tiled\.|"
                      r"mix_int8\.")
NOT_IN_SPAN = "(no span)"


def _events(prof):
    """(device intervals, host events {name: [start ns]}, block range,
    annotation facts) of a finished profile."""
    from torch.autograd import DeviceType

    from repro_torch import spans

    named = {r.name for r in spans.records()}
    dev, host, blocks = [], defaultdict(list), []
    has_attr, busy_named = None, set()
    for ev in prof.profiler.kineto_results.events():
        if has_attr is None:
            has_attr = hasattr(ev, "is_user_annotation")
        dur = ev.duration_ns()
        if dur <= 0:
            continue
        name = ev.name()
        is_range = ev.is_user_annotation() if has_attr else \
            name.startswith(("portbench.", "tiled.", "mix_int8."))
        if ev.device_type() == DeviceType.CUDA:
            if is_range:
                continue
            if name in named:
                busy_named.add(name)
            dev.append((ev.start_ns(), ev.start_ns() + dur))
        else:
            if name == "portbench.block":
                blocks.append((ev.start_ns(), ev.start_ns() + dur))
            if name in named:
                host[name].append(ev.start_ns())
    return dev, host, blocks, {"is_user_annotation": bool(has_attr),
                               "span_names_busy": sorted(busy_named)}


def _idle(dev, lo: int, hi: int, recs) -> dict:
    """{innermost span at each idle gap's midpoint: seconds} between
    ``lo`` and ``hi`` ns, over the spans ``recs``: of the spans that
    contain the midpoint, the one that started last."""
    if not dev:
        return {}
    ms, me = trace_lib._merge(np.array([a for a, _ in dev], np.int64),
                              np.array([b for _, b in dev], np.int64))
    gap_a = np.concatenate([[lo], me])
    gap_b = np.concatenate([ms, [hi]])
    keep = (gap_b > gap_a) & (gap_a >= lo) & (gap_b <= hi)
    recs = sorted(recs, key=lambda r: r.start_ns)
    starts = np.array([r.start_ns for r in recs], np.int64)
    out = defaultdict(float)
    for a, b in zip(gap_a[keep], gap_b[keep]):
        mid = (a + b) // 2
        name = NOT_IN_SPAN
        for j in range(int(np.searchsorted(starts, mid, "right")) - 1, -1,
                       -1):
            if recs[j].end_ns >= mid:
                name = recs[j].name
                break
        out[name] += (b - a) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _share(idle: dict) -> float | None:
    total = sum(idle.values())
    return (sum(s for n, s in idle.items() if SUBLAYER.match(n)) / total
            if total else None)


def _clock(host: dict, recs) -> dict:
    by_name = defaultdict(list)
    for r in recs:
        by_name[r.name].append(r.start_ns)
    diffs, unmatched = [], 0
    for name, starts in by_name.items():
        prof = sorted(host.get(name, []))
        starts = sorted(starts)
        if len(prof) != len(starts):
            unmatched += len(starts)
            continue
        diffs += [a - b for a, b in zip(starts, prof)]
    if not diffs:
        return {"spans": 0, "unmatched": unmatched}
    d = np.array(diffs, np.int64)
    size = np.abs(d)
    return {"spans": len(diffs), "unmatched": unmatched,
            "median_ns": float(np.median(d)),
            "p95_abs_ns": float(np.percentile(size, 95)),
            "max_abs_ns": int(size.max()), "min_ns": int(d.min()),
            "max_ns": int(d.max())}


def _cover(recs, blocks: list) -> dict:
    out = defaultdict(float)
    for r in recs:
        if r.block in blocks:
            out[r.name] += (r.end_ns - r.start_ns) / 1e9 / len(blocks)
    local = out.get("engine.local_updates", 0.0)
    three = sum(out.get(n, 0.0) for n in
                ("local.forward", "local.backward", "local.update"))
    return {"seconds": dict(sorted(out.items(), key=lambda kv: -kv[1])),
            "forward_backward_update_share": three / local if local
            else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (as portbench/run.py runs), or cpu to try "
                    "the report on a small cell")
    ap.add_argument("--root", help="the benchmark folder whose cells to "
                    "run (default portbench/)")
    args = ap.parse_args()
    seen: list = []
    summarize = trace_lib.summarize

    def reading(prof, window_s):
        # profile_blocks reads the blocks traced with the device alone,
        # then the host-traced block; each profile is read here as well
        seen.append(_events(prof))
        return summarize(prof, window_s)

    trace_lib.summarize = reading
    if args.device == "cuda":
        rc = harness.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"], T_START)
    else:
        root = Path(args.root) if args.root else harness.ROOT
        run = harness.run_cell(args.workload, args.seed, args.seconds, True,
                               device=args.device, t_start=T_START,
                               root=root)
        print(json.dumps(harness.result_line(run, True, root,
                                             device=args.device)))
        rc = 0
    if rc or len(seen) != 2:
        return rc or 1
    from repro_torch import spans

    recs = spans.records()
    marks = sorted(r.block for r in recs if r.name == spans.BLOCK)
    dev_blocks, host_block = marks[:-1], marks[-1]
    report = {"workload": args.workload, "seed": args.seed,
              "dropped": spans.dropped(),
              "calls": {n: c for n, (c, _) in spans.totals().items()},
              "cover": _cover(recs, dev_blocks),
              "annotation": seen[0][3] | {
                  "span_names_busy_host_traced": seen[1][3][
                      "span_names_busy"]}}
    for key, (dev, host, blocks, _), kept in (
            ("idle_device_traced", seen[0], set(dev_blocks)),
            ("idle_host_traced", seen[1], {host_block})):
        mine = [r for r in recs if r.block in kept]
        lo = min(r.start_ns for r in mine if r.name == spans.BLOCK)
        hi = max(r.end_ns for r in mine if r.name == spans.BLOCK)
        if blocks:
            lo, hi = min(a for a, _ in blocks), max(b for _, b in blocks)
        idle = _idle(dev, lo, hi, mine)
        report[key] = {"seconds": idle, "sublayer_share": _share(idle),
                       "total_s": sum(idle.values())}
    report["clock"] = _clock(seen[1][1],
                             [r for r in recs if r.block == host_block])
    print("span_report " + json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
