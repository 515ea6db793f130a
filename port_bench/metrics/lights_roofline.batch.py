"""``shadow.cu``'s multi-light mode's share of its roofline in a batch, in
%: the bound of ``port_bench.bounds_lights.lights_bound_s`` at the cell's
shapes over the time between CUDA events of the stage that runs it
(``batched.shade_lights_stage``, in ``entries/lights.py``'s split).  The
march's slab tests are not in the bound.  Nothing to read where the split
was not read (a program without that stage) or the shapes have no
lights."""

from port_bench import bounds_lights


def read(run):
    st, sh = run.stages, run.shapes or {}
    if not st or not st.get("split_ok") or not st.get("lights") \
            or not sh.get("lights"):
        return None
    bound = bounds_lights.lights_bound_s(sh["frames"], sh["height"],
                                         sh["width"], sh["volume"],
                                         sh["capacity"], sh["lights"])
    return 100.0 * bound * st["runs"] / (st["lights"] * 1e-3)
