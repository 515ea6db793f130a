"""Host milliseconds a live request spends in each span, for comparing two
trees.

    PYTHONPATH=<tree> python3 <this file> [requests]

Drives ``Session.feed`` on the graybox world on the card: 20 warm-up
requests, then ``requests`` (default 200) under a ``torch.profiler``, the
keys cycling through six bindings and the mouse through the view.  Prints
one JSON line: each ``frame``, ``frame.*``, ``batch``, ``batch.*`` and
``sync.*`` span (``runtime/tracing.py``) -> the mean host ms a request
spent in it (a span's time includes the spans inside it).  A span a tree
does not open is absent: ``sync.bincount``, for one, is the full rebin's
wait on ``torch.bincount`` where the rebin is the plain version.  It uses
only calls whose signatures are the same in every tree that has the
spans, so one copy times both trees; compare them in one call on one
card.  Needs a CUDA card.
"""

import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from pixel_art_raytracer_tpu_torch import RenderConfig, graybox_world
from pixel_art_raytracer_tpu_torch.device import require_cuda
from pixel_art_raytracer_tpu_torch.runtime import kernels
from pixel_art_raytracer_tpu_torch.runtime.session import Session

KEYS = [["left"], ["right"], ["a"], ["k"], ["up"], ["down"]]
PREFIXES = ("frame", "batch", "sync.")
WARM_UP = 20


def feed(session: Session, i: int) -> None:
    """Request ``i`` of the drive: one key and a mouse inside the view."""
    cfg = session.config
    session.feed(KEYS[i % len(KEYS)], mouse=((100 + i) % cfg.view_width,
                                             (120 + i) % cfg.view_height))


def split(session: Session, requests: int, warm_up: int = WARM_UP) -> dict:
    """Span name -> mean host ms a request over ``requests`` requests to
    ``session`` under a profiler, after ``warm_up`` requests outside it."""
    cuda = session.dscene.device.type == "cuda"
    for i in range(warm_up):
        feed(session, i)
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        for i in range(requests):
            feed(session, warm_up + i)
        if cuda:
            torch.cuda.synchronize()
    ms = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if (name.startswith(PREFIXES)
                and ev.device_type() == torch.autograd.DeviceType.CPU):
            ms[name] = ms.get(name, 0.0) + ev.duration_ns() / 1e6 / requests
    return dict(sorted(ms.items()))


def main(argv=None) -> int:
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    requests = int(argv[0]) if argv else 200
    kernels.library()
    session = Session(graybox_world(), config=RenderConfig())
    print(json.dumps({k: round(v, 4)
                      for k, v in split(session, requests).items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
