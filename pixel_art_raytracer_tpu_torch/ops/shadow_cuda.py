"""Wrapper of kernel 2 (``csrc/shadow.cu``): the per-pixel lit mask.

CPU tensors take the plain version, :func:`ops.shadow.trace_light_dynamic`;
CUDA tensors launch the kernel, and anything else raises.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels
from . import shadow

launches = 0

THREADS = 256
PIXELS_PER_BLOCK = 1024
# Shared memory a block may use on Hopper (opt-in above 48 KB).
MAX_SMEM = 227 * 1024


def trace_light(pos, ext, bins_ent, counts, start_bin, end_bin, start_ent,
                origin, inv_dir, players,
                config: RenderConfig) -> torch.Tensor:
    """Lit mask (F, H, W) bool: True where the light is reachable.

    Arguments as :func:`ops.shadow.trace_light_dynamic`; ``end_bin`` holds
    one light bin per frame, each component of shape (F, 1, 1).
    """
    global launches
    dev = bins_ent.device
    if dev.type == "cpu":
        return shadow.trace_light_dynamic(pos, ext, bins_ent, counts,
                                          start_bin, end_bin, start_ent,
                                          origin, inv_dir, players, config)
    if dev.type != "cuda":
        raise ValueError(f"trace_light: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    light_bin = torch.stack([b.reshape(F) for b in end_bin], dim=1)
    pixel = (F, H, W)
    checks = [
        (pos, "pos", torch.int32, (N, 3)),
        (ext, "ext", torch.int32, (N, 3)),
        (players, "players", torch.int32, (F, 3)),
        (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
        (counts, "counts", torch.int32, (F, V)),
        (start_ent, "start_ent", torch.int32, pixel),
        (light_bin, "light_bin", torch.int32, (F, 3)),
    ]
    checks += [(t, f"start_bin[{a}]", torch.int32, pixel)
               for a, t in enumerate(start_bin)]
    checks += [(t, f"origin[{a}]", torch.float32, pixel)
               for a, t in enumerate(origin)]
    checks += [(t, f"inv_dir[{a}]", torch.float32, pixel)
               for a, t in enumerate(inv_dir)]
    for t, name, dtype, shape in checks:
        kernels.require(t, name, dtype, shape, dev)
    smem = 4 * V * (cap + 1)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_light: a bin table of {V} x {cap} slots "
                         f"needs {smem} B of shared memory")

    lit = torch.empty(pixel, dtype=torch.bool, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_lit(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(),
            *(t.data_ptr() for t in start_bin),
            *(t.data_ptr() for t in origin),
            *(t.data_ptr() for t in inv_dir),
            start_ent.data_ptr(), light_bin.data_ptr(), lit.data_ptr(),
            F, W, H, cfg.bin_size, cap, cfg.hash_width, cfg.hash_height,
            cfg.hash_length, THREADS, PIXELS_PER_BLOCK,
            kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_lit")
    launches += 1
    return lit
