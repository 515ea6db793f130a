"""The host's time waiting for the card inside the batched path a frame,
in ms: the program's ``sync.*`` spans inside its ``batch`` spans (those
wholly inside the traced window), over their frames (F a span)."""

from port_bench import spans


def read(run):
    reqs = spans.requests(run.trace, "batch")
    if not reqs:
        return None
    return 1e3 * sum(spans.part_s(r, "sync.") for r in reqs) / (
        len(reqs) * run.shapes["frames"])
