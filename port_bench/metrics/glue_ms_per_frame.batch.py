"""The G-buffer glue of the directional route, ms a frame between CUDA
events: the ``gbuffer`` (``trace.materialize_gbuffer``), ``dot``
(``shadow_dir.direction_constants`` and ``shade.lambert_dot``) and
``shade`` (``shade.factor_from_dot`` and the dither of
``batched.shade_stage``) stages, over the batches the traced run drives
stage by stage."""


def read(run):
    st = run.stages
    if not st or not st.get("split_ok") or "gbuffer" not in st:
        return None
    return (st["gbuffer"] + st["dot"] + st["shade"]) / st["frames"]
