"""Slab tests a pixel-light of ``shadow.cu``'s multi-light mode: the
program's counter of the tests its launches performed while the profiler
recorded (``shadow_cuda.counters``: ``light_slab_tests``, on its lists and
in its direct march, over all lights) over the pixel-lights of those
launches (``light_pixels``, F * H * W * L a launch).  Nothing to read in a
run that was not traced, or where the program has no such counter."""

from pixel_art_raytracer_tpu_torch.ops import shadow_cuda


def read(run):
    if run.trace is None:
        return None
    counters = getattr(shadow_cuda, "counters", None)
    c = counters.read() if counters is not None else {}
    if not c.get("light_pixels"):
        return None
    return c.get("light_slab_tests", 0) / c["light_pixels"]
