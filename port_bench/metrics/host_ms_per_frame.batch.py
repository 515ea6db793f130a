"""The host's time in the batched path a frame, in ms: the program's
``batch`` spans (one call of ``render_states_batched``) that lie wholly
inside the traced window, over their frames (F a span)."""

from port_bench import spans


def read(run):
    reqs = spans.requests(run.trace, "batch")
    if not reqs:
        return None
    return 1e3 * sum(e - s for s, e, _ in reqs) / (
        len(reqs) * run.shapes["frames"])
