"""The program's spans, on the profiler's clock.

:func:`span` opens a ``torch.profiler.record_function`` range while a torch
profiler records in this process, and returns one shared no-op context
otherwise: with no profiler, a span costs one flag read, where an entered
``record_function`` would cost some 10 µs.  The profiler keeps the ranges
in memory beside the device activities, on the same clock, and a Chrome
trace (``utils/metrics.profiler_trace``) shows them above the kernels they
launched.  There is no other store.

The spans, from the requests down:

* ``batch``: one request to the batched path
  (``models/batched.render_states_batched`` or ``gbuffer_and_frames``, or
  ``models/supersample.SupersampledRenderer.render_states``, whose span
  holds the batched path's and the box filter's);
* ``batch.<stage>``: each stage function of ``models/batched.py``
  (``bins``, ``trace``, ``shade``, ``geometry``, ``shadow``, ``fused``,
  ``lights``, ``directional``), and inside them ``batch.gbuffer`` (the
  G-buffer of the winners, in ``batch.trace`` or ``batch.fused``) and
  ``batch.dither`` (the G-buffer route's ordered dither, in
  ``batch.shade``); ``batch.filter``, the supersampled frames' box filter;
* ``frame``: one live request (``runtime.session.Session.feed``, the
  viewer's frame), with ``frame.overlay`` (the host copy and its debug
  line) and ``frame.keep`` (the session's record of the frame);
* ``sync.upload``, ``sync.bincount``, ``sync.fetch``, ``sync.readback``:
  every point of those paths where the host waits for the card: a copy
  from pageable host memory to the card (which waits for the stream), the
  full rebin's ``torch.bincount`` (which reads its input's range to size
  its output), the frame's copy to the host and the two G-buffer values
  of the mouse pixel.

:func:`active` also tells the kernels' wrappers to count: the winner-input
and multi-light marches count their slab tests only while a profiler
records (``ops/shadow_cuda.shade_point``, ``shade_lights``).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether a torch profiler records in this process."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call

    return wrap
