"""The host's time waiting for the card in a live request, in ms: the
program's ``sync.*`` spans (the uploads, the frame's fetch, the mouse
pixel's readback) inside its ``frame`` spans (those wholly inside the
traced window), over the requests."""

from port_bench import spans


def read(run):
    reqs = spans.requests(run.trace, "frame")
    if not reqs:
        return None
    return 1e3 * sum(spans.part_s(r, "sync.") for r in reqs) / len(reqs)
