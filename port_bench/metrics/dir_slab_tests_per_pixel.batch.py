"""Slab tests a pixel of ``shadow.cu``'s directional mode: the program's
counter of the tests its launches performed (``shadow_cuda.counters``:
``slab_tests``, on its union lists and in its direct march) over the
pixels of those launches (``dir_pixels``, F * H * W a launch), over the
whole run.  Nothing to read in a run that was not traced, or where the
program has no such counter."""

from pixel_art_raytracer_tpu_torch.ops import shadow_cuda


def read(run):
    if run.trace is None:
        return None
    c = shadow_cuda.counters.read()
    if not c.get("dir_pixels"):
        return None
    return c["slab_tests"] / c["dir_pixels"]
