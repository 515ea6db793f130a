"""``shadow.cu``'s winner-input mode's share of its roofline in a batch,
in %: the bound of ``port_bench.bounds.shade_bound_s`` at the cell's
shapes over the shade stage's (``batched.shade_point_stage``) time between
CUDA events.  The march's slab tests are not in the bound."""

from port_bench import bounds


def read(run):
    st = run.stages
    if not st or not st.get("split_ok") or st["shade"] <= 0:
        return None
    sh = run.shapes
    bound = bounds.shade_bound_s(sh["frames"], sh["height"], sh["width"],
                                 sh["volume"], sh["capacity"])
    return 100.0 * bound * st["runs"] / (st["shade"] * 1e-3)
