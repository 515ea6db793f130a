"""The program's spans in a traced window, for the metric readers.

The program (``runtime/tracing.py`` of the port) opens
``torch.profiler.record_function`` ranges while the profiler records, so
they arrive among the trace's host operations (``Trace.host_ops``), on the
clock of the device activities: a request's span, ``batch`` (one call of
the batched path) or ``frame`` (one live request), and inside it the
spans of its parts, ``batch.<stage>``, ``frame.<part>`` and
``sync.<what>`` (where the host waits for the card).  A program without
them gives nothing to read.

A request counts only where it lies wholly inside the traced window.  No
range opened before the profiler started is recorded; one still open when
it stops is cut at the stop, so the request that ends last is left out,
as its end cannot be told from such a cut.
"""

from __future__ import annotations

# The clock's resolution in seconds since the epoch (a double holds them
# to about 0.24 µs), for comparing a part's ends with its request's.
SLACK_S = 1e-6


def is_span(name: str) -> bool:
    return name in ("batch", "frame") or name.startswith(
        ("batch.", "frame.", "sync."))


def requests(trace, name: str) -> list[tuple[float, float, list]]:
    """The spans ``name`` of ``trace`` that are not inside another of that
    name and lie wholly inside the window: ``(start_s, end_s, parts)``,
    ``parts`` the program's other spans inside it, ``(start_s, end_s,
    name)``."""
    if trace is None or not trace.host_ops:
        return []
    spans = sorted((op for op in trace.host_ops if is_span(op[2])),
                   key=lambda op: (op[0], -op[1]))
    out: list[tuple[float, float, list]] = []
    for s, e, n in spans:
        if out and s >= out[-1][0] - SLACK_S and e <= out[-1][1] + SLACK_S:
            if n != name:
                out[-1][2].append((s, e, n))
        elif n == name:
            out.append((s, e, []))
    last = max(e for _, e, _ in trace.host_ops)
    return [r for r in out if r[1] < last - SLACK_S]


def part_s(request, prefix: str) -> float:
    """Seconds of a request's parts whose names start with ``prefix``."""
    return sum(e - s for s, e, n in request[2] if n.startswith(prefix))
