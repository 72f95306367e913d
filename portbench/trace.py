"""The traced blocks of a ``--trace 1`` run, read from ``torch.profiler``'s
raw events.

Device time is read from the trace's raw events (``kineto_results``), not
from ``key_averages()``, which builds every host event and takes minutes
at a few hundred thousand launches.  The device-side copies of
``record_function`` ranges are left out: they repeat their kernels' time.
``busy_s`` is the union of the device intervals (kernels, copies, sets),
so overlapping work counts once; the idle gaps between them are named by
the innermost host operation running at each gap's midpoint.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["profile_blocks", "summarize", "kernel_time"]

#: how many host events back from a gap a containing operation is looked
#: for before the gap is put down to the host between operations
_LOOKBACK = 256
_BETWEEN = "host between operations"


def profile_blocks(step, state, count: int, device) -> dict:
    """Run ``step(j, state) -> (state, metrics)`` for ``j < count`` under
    the profiler with the device's activity alone (recording every host
    operation as well slows the host, and so lengthens the device's idle
    gaps), then one more block with the host's operations too, which
    names what the host did in that block's idle gaps.  Returns
    :func:`summarize`'s dict of the first ``count`` blocks, the second's
    ``idle_gaps``, and the final ``state``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    host = [ProfilerActivity.CPU]
    dev = [ProfilerActivity.CUDA] if cuda else host

    def window(acts, first, n, st):
        if cuda:
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for j in range(first, first + n):
                with record_function("portbench.block"):
                    st, _ = step(j, st)
            if cuda:
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
        return prof, seconds, st

    prof, seconds, state = window(dev, 0, count, state)
    t1 = time.perf_counter()
    out = summarize(prof, seconds)
    del prof
    both, host_s, state = window(host + dev if cuda else host, count, 1,
                                 state)
    out["idle_gaps"] = summarize(both, host_s)["idle_gaps"]
    out["host_traced_block_s"] = host_s
    out["read_s"] = time.perf_counter() - t1
    out["blocks"] = count
    out["state"] = state
    return out


def _merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as (merged starts, merged ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    # a new interval begins where its start passes every earlier end
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    ms = s[idx]
    me = np.append(run_end[idx[1:] - 1], run_end[-1])
    return ms, me


def summarize(prof, window_s: float) -> dict:
    """{"busy_s", "window_s", "by_name": {name: (launches, seconds)},
    "device_ops": top 10 [name, seconds], "idle_gaps": top 10 [host
    operation, seconds]} of a finished profile."""
    from torch.autograd import DeviceType

    dev_s, dev_e, dev_n = [], [], []
    host_s, host_e, host_n = [], [], []
    blocks = []
    for ev in prof.profiler.kineto_results.events():
        dur = ev.duration_ns()
        if dur <= 0:
            continue
        name = ev.name()
        annotation = getattr(ev, "is_user_annotation", None)
        is_range = annotation() if annotation is not None else \
            name.startswith(("portbench.", "tiled.", "mix_int8."))
        start = ev.start_ns()
        if ev.device_type() == DeviceType.CUDA:
            if is_range:
                continue
            dev_s.append(start)
            dev_e.append(start + dur)
            dev_n.append(name)
        else:
            if name == "portbench.block":
                blocks.append((start, start + dur))
            host_s.append(start)
            host_e.append(start + dur)
            host_n.append(name)
    out = {"window_s": window_s, "busy_s": 0.0, "by_name": {},
           "device_ops": [], "idle_gaps": []}
    if not dev_s:
        return out
    ds, de = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
    by = defaultdict(lambda: [0, 0])
    for n, a, b in zip(dev_n, dev_s, dev_e):
        by[n][0] += 1
        by[n][1] += b - a
    out["by_name"] = {n: (c, ns / 1e9) for n, (c, ns) in by.items()}
    out["device_ops"] = [[n, ns / 1e9] for n, (c, ns) in
                         sorted(by.items(), key=lambda kv: -kv[1][1])[:10]]
    ms, me = _merge(ds, de)
    out["busy_s"] = float((me - ms).sum()) / 1e9
    # idle gaps inside the traced blocks, before, between and after the
    # device's intervals
    lo = min(b[0] for b in blocks) if blocks else int(ms[0])
    hi = max(b[1] for b in blocks) if blocks else int(me[-1])
    gap_a = np.concatenate([[lo], me])
    gap_b = np.concatenate([ms, [hi]])
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    hs = np.array(host_s, np.int64)
    he = np.array(host_e, np.int64)
    order = np.argsort(hs, kind="stable")
    hs, he = hs[order], he[order]
    names = [host_n[i] for i in order]
    idle = defaultdict(int)
    mids = (gap_a + gap_b) // 2
    pos = np.searchsorted(hs, mids, side="right")
    for a, b, m, p in zip(gap_a, gap_b, mids, pos):
        label = _BETWEEN
        for j in range(p - 1, max(-1, p - 1 - _LOOKBACK), -1):
            if he[j] >= m and names[j] != "portbench.block":
                label = names[j]
                break
        idle[label] += int(b - a)
    out["idle_gaps"] = [[n, ns / 1e9] for n, ns in
                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return out


def kernel_time(summary: dict, function: str) -> tuple[int, float]:
    """(launches, device seconds) of the device events whose name holds
    the kernel function ``function`` as a whole word."""
    pat = re.compile(rf"\b{re.escape(function)}\b")
    count, seconds = 0, 0.0
    for name, (c, s) in summary.get("by_name", {}).items():
        if pat.search(name):
            count += c
            seconds += s
    return count, seconds
