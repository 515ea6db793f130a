"""``shadow.cu``'s directional mode's share of its roofline in a batch, in
%: the bound of ``port_bench.bounds_sun.dir_march_bound_s`` at the cell's
shapes over the march stage's (``shadow_cuda.trace_light_directional``
alone) time between CUDA events.  The march's slab tests are not in the
bound."""

from port_bench import bounds_sun


def read(run):
    st = run.stages
    if not st or not st.get("split_ok") or not st.get("march"):
        return None
    sh = run.shapes
    bound = bounds_sun.dir_march_bound_s(sh["frames"], sh["height"],
                                         sh["width"], sh["volume"],
                                         sh["capacity"])
    return 100.0 * bound * st["runs"] / (st["march"] * 1e-3)
