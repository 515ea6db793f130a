"""Slab tests a pixel of ``shadow.cu``'s winner-input mode: the program's
counter of the tests its launches performed while the profiler recorded
(``shadow_cuda.counters``: ``shade_slab_tests``, on its lists and in its
direct march) over the pixels of those launches (``shade_pixels``, F * H
* W a launch).  Nothing to read in a run that was not traced, or where the
program has no such counter."""

from pixel_art_raytracer_tpu_torch.ops import shadow_cuda


def read(run):
    if run.trace is None:
        return None
    c = shadow_cuda.counters.read()
    if not c.get("shade_pixels"):
        return None
    return c["shade_slab_tests"] / c["shade_pixels"]
