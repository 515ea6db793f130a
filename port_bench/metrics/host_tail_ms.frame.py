"""The host's work on a live request after its frame reaches the host, in
ms: the program's ``frame.overlay`` (the host copy and the debug line) and
``frame.keep`` (the session's record) spans inside its ``frame`` spans
(those wholly inside the traced window), over the requests."""

from port_bench import spans


def read(run):
    reqs = spans.requests(run.trace, "frame")
    if not reqs:
        return None
    return 1e3 * sum(spans.part_s(r, "frame.overlay")
                     + spans.part_s(r, "frame.keep") for r in reqs) / len(reqs)
