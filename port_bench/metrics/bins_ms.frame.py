"""A frame's full rebin (``DeferredRenderer.build_bins`` in the session,
``batched.bin_stage`` with no cache in a still), ms a frame between CUDA
events, over the requests the traced run drives stage by stage."""


def read(run):
    st = run.stages
    if not st or not st.get("split_ok"):
        return None
    return st["bins"] / st["frames"]
