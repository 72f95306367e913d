"""Host seconds of a program span a traced block, read from the port's
span store (:mod:`repro_torch.spans`) after a ``--trace 1`` run.

The store fills only while a profiler runs, so in a run it holds the
traced blocks alone: first the ``run["trace"]["blocks"]`` blocks traced
with the device's activity, then the one traced with every host
operation, which is left out (the host's tracing lengthens it).  A span
of a name counts once however deep it lies, but not again inside a span
of the same name."""
from __future__ import annotations

__all__ = ["BLOCK", "per_block", "block_seconds"]

#: the span of one engine block
BLOCK = "engine.block"


def block_seconds(records, name: str, blocks: int) -> float | None:
    """Seconds of the top-level spans ``name`` in the first ``blocks``
    engine blocks of ``records`` (:class:`repro_torch.spans.Span`), over
    ``blocks``; None when there are fewer blocks or no such span."""
    marks = sorted(r.block for r in records if r.name == BLOCK)
    if blocks < 1 or len(marks) < blocks:
        return None
    kept = set(marks[:blocks])
    by_id = {r.id: r for r in records}

    def nested(r) -> bool:
        p = by_id.get(r.parent)
        while p is not None:
            if p.name == name:
                return True
            p = by_id.get(p.parent)
        return False

    ns = [r.end_ns - r.start_ns for r in records
          if r.name == name and r.block in kept and not nested(r)]
    return sum(ns) / 1e9 / blocks if ns else None


def per_block(run: dict, name: str) -> float | None:
    """:func:`block_seconds` of the run's traced blocks; None when the
    run was not traced or the program keeps no span store."""
    traced = run.get("trace")
    if not traced:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return block_seconds(spans.records(), name, traced["blocks"])
