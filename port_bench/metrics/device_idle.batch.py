"""The card's idle share in the traced part of a batch cell's window, in
%: 1 - busy / span, busy the union of the device activities' intervals,
span the first activity's start to the last one's end."""


def read(run):
    if run.trace is None or run.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
