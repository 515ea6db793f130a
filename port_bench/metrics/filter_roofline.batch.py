"""The box filter's share of its roofline in a batch, in %: the bound of
``port_bench.bounds_filter.filter_bound_s`` at the cell's shapes over the
filter stage's time between CUDA events in ``entries/filtered.py``'s
split (``box_filter`` of the batch's traced frames)."""

from port_bench import bounds_filter


def read(run):
    st, sh = run.stages, run.shapes
    if not st or not st.get("split_ok") or not st.get("filter") \
            or "supersample" not in sh:
        return None
    bound = bounds_filter.filter_bound_s(sh["frames"], sh["height"],
                                         sh["width"], sh["supersample"])
    return 100.0 * bound * st["runs"] / (st["filter"] * 1e-3)
