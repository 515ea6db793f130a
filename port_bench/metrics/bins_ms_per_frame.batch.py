"""The bins stage of the batched main path (``batched.bin_stage``, the
``StaticBins`` merge of the player), ms a frame between CUDA events, over
the batches the traced run drives stage by stage."""


def read(run):
    st = run.stages
    if not st or not st.get("split_ok"):
        return None
    return st["bins"] / st["frames"]
