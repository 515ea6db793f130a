"""Share of the pixels that ``shadow.cu``'s winner-input directional mode
marched, in %: the program's counter of the pixels its launches marched
(``shadow_cuda.counters``: ``dir_marched_pixels``, on its lists and
directly; a pixel whose colour no shadow can change is not marched) over
the pixels of those launches (``dir_shade_pixels``, F * H * W a launch),
over the whole run.  Nothing to read in a run that was not traced, or
where the program has no such counter."""

from pixel_art_raytracer_tpu_torch.ops import shadow_cuda


def read(run):
    if run.trace is None:
        return None
    counters = getattr(shadow_cuda, "counters", None)
    c = counters.read() if counters is not None else {}
    if "dir_marched_pixels" not in c or not c.get("dir_shade_pixels"):
        return None
    return 100.0 * c["dir_marched_pixels"] / c["dir_shade_pixels"]
