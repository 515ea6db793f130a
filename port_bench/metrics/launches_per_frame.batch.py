"""Device operations (kernels, copies, fills) a frame in the traced part
of a batch cell's window: every launch of the batch, the benchmark's
per-frame checksum and sample copies included."""


def read(run):
    if run.trace is None or not run.traced_units or not run.trace.activities:
        return None
    return len(run.trace.activities) / run.traced_units
