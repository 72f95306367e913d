"""Program spans: the port's one tracing mechanism, on exactly while a
``torch.profiler`` session runs.

``with span("local.forward"): ...`` marks a region of the program.  With
no profiler running (``torch.autograd.profiler._is_profiler_enabled``
false, PyTorch's own Python flag) a span reads that flag and does nothing
else: no ``record_function``, no record, no sync, no autograd node.  With
a profiler running it opens a ``torch.profiler.record_function`` range,
so the profiler places the span on the timeline of the device activity
it traces and ties each kernel launched inside it to the span, and it
appends a :class:`Span` to an in-memory store: name, start and end on the
clock the profiler stamps host events with (Unix-epoch nanoseconds,
``time.time_ns()``; each the midpoint of the clock read just before and
just after the range's own entry or exit, inside which the profiler
takes its stamp), the id of the enclosing span, the thread, and the
index of the engine block it belongs to.  The store is bounded
(:data:`CAPACITY`; the rest are counted in :func:`dropped`) and written
to no file: an operator reads the spans in their own profiler trace, and
the benchmark reads :func:`records` in-process.

The spans of a training block, from the outside in::

    engine.block                  one block step of an engine
      engine.prologue             participation, graph, draws, step sizes
      engine.local_updates        the region metrics["local_s"] times
        local.step                one of the T local steps
          local.forward           one agent's loss (stacked_grad)
            model.embed | model.attention | model.mlp | model.moe
            | model.ssm | model.head_loss
          local.backward          the one torch.autograd.grad call
            model.layer.backward  one layer of one agent, backward
              model.attention.backward | model.ssm.backward
          local.update            the optimizer and w - mu u
      engine.combination          the region metrics["combine_s"] times
        tiled.gather | tiled.scatter | mix_int8.*

The backward runs on autograd's device thread for CUDA tensors.  A span
opened on a thread with no open span of its own takes as its parent the
most recently opened span still open on any thread: for the backward's
spans, the ``local.backward`` that waits for them.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["BLOCK", "CAPACITY", "Span", "span", "mark_layer_input",
           "mark_layer_output", "records", "reset", "dropped", "totals"]

#: the span that starts an engine block; each one opened advances the
#: block index the spans opened after it carry
BLOCK = "engine.block"
#: records the store keeps; the rest are counted, not kept
CAPACITY = 1 << 18


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None    # the enclosing span's id (None at the top)
    thread: int
    block: int            # index of the engine.block it lies in (-1: none)


_records: list[Span] = []
_dropped = 0
_ids = itertools.count()
_block = -1
_live: list[int] = []          # ids of open spans, oldest first, any thread
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Token:
    __slots__ = ("id", "name", "start", "parent", "block", "stack", "rf")


def _open_span(name: str) -> _Token | None:
    """Open span ``name`` (None when no profiler runs); close it with
    :func:`_close_span`, on the same thread or another."""
    global _block
    if not _profiler._is_profiler_enabled:
        return None
    tok = _Token()
    tok.rf = torch.profiler.record_function(name)
    before = time.time_ns()
    tok.rf.__enter__()
    tok.start = (before + time.time_ns()) // 2
    stack = _stack()
    tok.id, tok.name, tok.stack = next(_ids), name, stack
    tok.parent = stack[-1] if stack else (_live[-1] if _live else None)
    if name == BLOCK:
        _block += 1
    tok.block = _block
    stack.append(tok.id)
    _live.append(tok.id)
    return tok


def _remove(ids: list, i: int) -> None:
    # spans close innermost first, so this is nearly always the last
    for j in range(len(ids) - 1, -1, -1):
        if ids[j] == i:
            del ids[j]
            return


def _close_span(tok: _Token | None) -> None:
    """Close a span :func:`_open_span` returned, and store it."""
    global _dropped
    if tok is None:
        return
    _remove(tok.stack, tok.id)
    _remove(_live, tok.id)
    before = time.time_ns()
    tok.rf.__exit__(None, None, None)
    end = (before + time.time_ns()) // 2
    if len(_records) < CAPACITY:
        _records.append(Span(tok.id, tok.name, tok.start, end, tok.parent,
                             threading.get_ident(), tok.block))
    else:
        _dropped += 1


_NULL = contextlib.nullcontext()


class _Range:
    __slots__ = ("name", "tok")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.tok = _open_span(self.name)

    def __exit__(self, *exc):
        _close_span(self.tok)
        return False


def span(name: str):
    """A context manager marking a region as span ``name``; with no
    profiler running it does nothing but read the profiler's flag."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Range(name)


class _LayerMark(torch.autograd.Function):
    """Identity (a view, no copy) whose backward opens the layer's
    backward span, at the layer's output, where the layer's backward
    starts, or closes it, at the layer's input, where it ends."""

    @staticmethod
    def forward(ctx, x, slot, opens):
        ctx.slot, ctx.opens = slot, opens
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            ctx.slot.append(_open_span("model.layer.backward"))
        elif ctx.slot:
            _close_span(ctx.slot.pop())
        return g, None, None


def mark_layer_input(x: torch.Tensor):
    """``(x, slot)``: while a profiler runs and ``x`` takes a gradient, x
    behind the mark that closes the layer's ``model.layer.backward`` span;
    else x itself and ``None``.  Hand ``slot`` to
    :func:`mark_layer_output`."""
    if not (_profiler._is_profiler_enabled and x.requires_grad
            and torch.is_grad_enabled()):
        return x, None
    slot: list = []
    return _LayerMark.apply(x, slot, False), slot


def mark_layer_output(x: torch.Tensor, slot) -> torch.Tensor:
    """The layer's output behind the mark that opens its
    ``model.layer.backward`` span (x itself when ``slot`` is None)."""
    if slot is None:
        return x
    return _LayerMark.apply(x, slot, True)


def records() -> list[Span]:
    """The stored spans, in the order they closed."""
    return list(_records)


def dropped() -> int:
    """Spans closed while the store was full, and so not kept."""
    return _dropped


def reset() -> None:
    """Empty the store and restart the block index."""
    global _dropped, _block
    _records.clear()
    _live.clear()
    _dropped = 0
    _block = -1


def totals() -> dict:
    """{name: (calls, seconds)} over the stored spans."""
    out = defaultdict(lambda: [0, 0])
    for r in _records:
        out[r.name][0] += 1
        out[r.name][1] += r.end_ns - r.start_ns
    return {n: (c, ns / 1e9) for n, (c, ns) in out.items()}
