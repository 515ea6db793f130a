"""Wrapper of the box filter kernel (``csrc/filter.cu``): the truncated mean
of each s x s block of (H s, W s, 3) or (F, H s, W s, 3) uint8 frames in
one launch, with no host wait.

``models/supersample.box_filter`` routes CUDA tensors here and keeps the
plain chain for CPU tensors; this wrapper only launches, and raises for a
tensor on any other device.  ``filter_launches`` counts its launches (one
a call).
"""

from __future__ import annotations

import torch

from ..runtime import kernels

filter_launches = 0


def box_filter(frames: torch.Tensor, s: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 of contiguous (..., H s, W s, 3) uint8 frames,
    ``...`` empty or one frame axis; the plain chain's result bit for
    bit.  A factor whose tile does not fit a block's shared memory (63 and
    up) is refused by the C entry, and raises ``RuntimeError``."""
    global filter_launches
    dev = frames.device
    if frames.dim() not in (3, 4):
        raise ValueError(f"box_filter: frames of shape "
                         f"{tuple(frames.shape)}, expected (H s, W s, 3) "
                         f"or (F, H s, W s, 3)")
    kernels.require(frames, "frames", torch.uint8,
                    (None,) * (frames.dim() - 1) + (3,), dev)
    hs, ws = frames.shape[-3:-1]
    if s < 1 or hs % s or ws % s:
        raise ValueError(f"box_filter: factor {s} does not divide "
                         f"{hs}x{ws}")
    if dev.type != "cuda":
        raise ValueError(f"box_filter: no kernel for device {dev}")
    out = torch.empty((*frames.shape[:-3], hs // s, ws // s, 3),
                      dtype=torch.uint8, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_box_filter(frames.data_ptr(), out.data_ptr(),
                                out.numel() // (3 * (ws // s)), ws // s, s,
                                kernels.stream_handle(dev))
    kernels.check(rc, "par_box_filter")
    filter_launches += 1
    return out
