"""``trace.cu``'s share of its roofline in a batch, in %: the bound of
``port_bench.bounds.trace_bound_s`` at the cell's shapes over the winner
stage's (``batched.winner_stage``) time between CUDA events."""

from port_bench import bounds


def read(run):
    st = run.stages
    if not st or not st.get("split_ok") or st["trace"] <= 0:
        return None
    sh = run.shapes
    bound = bounds.trace_bound_s(sh["frames"], sh["height"], sh["width"],
                                 sh["volume"], sh["capacity"])
    return 100.0 * bound * st["runs"] / (st["trace"] * 1e-3)
