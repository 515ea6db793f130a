"""Wrappers of kernel 2 (``csrc/shadow.cu``): the per-pixel lit mask of a
point light (:func:`trace_light`, from a G-buffer's ray inputs) or a
directional light (:func:`trace_light_directional`) per frame, and the
shaded frames straight from the trace kernel's winners of a point light
(:func:`shade_point`, or its lit mask), of L point lights whose diffuse
adds (:func:`shade_lights`) or of a directional light
(:func:`shade_directional`) per frame.  The point modes, and the fused
kernel (``fused_cuda``), run one march (``csrc/common.cuh`` march_band),
whose block :func:`shade_smem_bytes` sizes.

CPU tensors take the plain versions, :func:`ops.shadow.trace_light_dynamic`,
:func:`ops.shadow_dir.trace_light_directional`,
:func:`ops.shade.point_frames`, :func:`ops.shade.light_frames` and
:func:`ops.shade.directional_frames`; CUDA tensors launch the kernel, and
anything else raises.  ``launches``, ``directional_launches``,
``shade_launches``, ``light_launches`` and ``dir_shade_launches`` count
the five modes' launches; ``counters`` holds the kernel's device counters
of all five (pixels marched directly, the most keys in a band of the point
march or a tile of the directional one, the longest visit list), of the
two directional modes (union entries staged, slab tests performed, and
the pixels of their launches on the host), the pixels the winner-input
directional mode marched and, while the program is
traced (``runtime/tracing.py``), of the winner-input point and
multi-light modes (slab tests performed, pixels or pixel-lights marched,
and those of their launches on the host).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig
from ..runtime import kernels, tracing
from . import dither, shade, shadow, shadow_dir, trace, trace_cuda

launches = 0
directional_launches = 0
shade_launches = 0
light_launches = 0
dir_shade_launches = 0
counters = kernels.MarchCounters()

# Shared memory a block may use on Hopper (opt-in above 48 KB).
MAX_SMEM = 227 * 1024
# csrc/common.cuh: kShadeKeys, the start bins a band's table of the point
# march holds; kMarchThreads, the most threads a march block may have (and
# the threads of a point-march block); kMarchBlocksPerSM, the blocks an SM
# should hold (the march kernels' launch bound).
STARTS = 4
MARCH_THREADS = 320
MARCH_BLOCKS_PER_SM = 4
# The most list entries the point march stages at once.
SHADE_CHUNK = 32
# csrc/common.cuh ShadeKey: one key's DDA state, 16 ints.
SHADE_KEY_BYTES = 64
# Shared memory of a Hopper SM, and what the runtime reserves a block.
SM_SMEM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
# The styles of the winner-input directional mode (models/deferred.STYLES).
STYLES = ("reference", "dithered")
# csrc/shadow.cu kNoTexel: the texel offset in a sprite that marks a
# background pixel, so a sprite holds fewer texels.
NO_TEXEL = 0xFFFF


def march_threads(config: RenderConfig) -> int:
    """Threads of a directional march block, which takes one bin-column
    tile of bin_size**2 pixels: the largest warp multiple up to
    MARCH_THREADS that divides the pixels (320 for 40x40 tiles), else
    256."""
    n_pix = config.bin_size ** 2
    return next((t for t in range(MARCH_THREADS, 31, -32)
                 if n_pix % t == 0), 256)


def shade_smem_bytes(config: RenderConfig, chunk: int | None = None,
                     reserve: int = 0) -> int:
    """Shared memory of csrc/common.cuh ``ShadeSmem``, the point march's
    block (both point modes), at ``chunk`` list entries staged at once
    (default :func:`shade_chunk`): a head of the staged entries' ``cap``
    candidates (two float4 each), live counts and bins, each warp's and the
    band's start bins (8 B each), STARTS key states, the warps' counts and
    table indices, 2 control ints and a V-bit mask of listed bins per key,
    or ``reserve`` bytes where that is more (``fused_cuda``'s draw list);
    then 29 B a pixel of the band (the ray origin's y and z, entity, texel,
    the reciprocal direction, a state byte).  A band is ``trace.cu``'s
    (:func:`trace_cuda.band_rows` rows, at most 1,600 pixels), so only the
    masks grow with the grid's volume V: at capacity 8 and 32 entries the
    block fits MAX_SMEM up to V = 353,568 bins."""
    cfg = config
    V, cap = cfg.hash_volume, cfg.bin_capacity
    warps = MARCH_THREADS // 32
    n_pix = trace_cuda.band_pixels(cfg)
    if chunk is None:
        chunk = shade_chunk(cfg)
    head = (32 * chunk * cap + 8 * (warps + 1) * STARTS
            + SHADE_KEY_BYTES * STARTS
            + 4 * (2 * chunk + warps + warps * STARTS + 2)
            + 4 * STARTS * -(-V // 32))
    return max(head, reserve) + 29 * n_pix


def shade_chunk(config: RenderConfig, smem_bytes=None) -> int:
    """List entries the point march stages at once: the most, up to
    SHADE_CHUNK, at which MARCH_BLOCKS_PER_SM blocks of ``smem_bytes(chunk)``
    bytes (default: :func:`shade_smem_bytes`) fit an SM's shared memory,
    else SHADE_CHUNK (graybox 32; config 5 28, where 32 would hold an SM to
    3 blocks; the 52 x 52 x 8 grid 32, 3 blocks at any chunk)."""
    if smem_bytes is None:
        def smem_bytes(chunk):
            return shade_smem_bytes(config, chunk)
    for chunk in range(SHADE_CHUNK, STARTS - 1, -1):
        if MARCH_BLOCKS_PER_SM * (smem_bytes(chunk)
                                  + BLOCK_RESERVED_SMEM) <= SM_SMEM:
            return chunk
    return SHADE_CHUNK


def trace_light(pos, ext, bins_ent, counts, start_bin, end_bin, start_ent,
                origin, inv_dir, players, config: RenderConfig,
                max_steps: int | None = None, rows=None) -> torch.Tensor:
    """Lit mask (F, H, W) bool: True where the light is reachable.

    Arguments as :func:`ops.shadow.trace_light_dynamic`; ``end_bin`` holds
    one light bin per frame, each component of shape (F, 1, 1), and
    ``max_steps`` caps each ray at ``7 * min(int(largest), max_steps)``
    phases (None: no cap, the render paths' exact march).
    ``rows=(row0, n_rows)``, a window of whole bin rows
    (``trace.row_window``), launches over that window only: the per-pixel
    inputs and the mask are then (F, n_rows, W).  The kernel runs the
    point march of :func:`shade_point` on the rays, whatever they are; it
    raises ``ValueError`` where :func:`shade_point` would, past 353,568
    bins at capacity 8.
    """
    global launches
    dev = bins_ent.device
    row0, n_rows = trace.row_window(config, rows)
    if max_steps is not None and max_steps < 0:
        raise ValueError(f"trace_light: max_steps {max_steps} < 0")
    if dev.type == "cpu":
        return shadow.trace_light_dynamic(pos, ext, bins_ent, counts,
                                          start_bin, end_bin, start_ent,
                                          origin, inv_dir, players, config,
                                          max_steps=max_steps)
    if dev.type != "cuda":
        raise ValueError(f"trace_light: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    light_bin = torch.stack([b.reshape(F) for b in end_bin], dim=1)
    pixel = (F, n_rows, W)
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
    chunk = shade_chunk(cfg)
    smem = shade_smem_bytes(cfg, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_light: the visit-list masks of a {V}-bin "
                         f"grid and a band of {trace_cuda.band_rows(cfg)} rows "
                         f"of {cfg.bin_size} pixels need {smem} B of shared "
                         f"memory, over the {MAX_SMEM} B a block may use")

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
            counters.tensor(dev).data_ptr(),
            F, W, H, cfg.bin_size, cap, cfg.hash_width, cfg.hash_height,
            cfg.hash_length, row0 // cfg.bin_size,
            -(-n_rows // cfg.bin_size),
            -1 if max_steps is None else max_steps, chunk, MARCH_THREADS,
            kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_lit")
    launches += 1
    return lit


def shade_point(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                atlas_normal, palette, bins_ent, counts, players, lights,
                config: RenderConfig, frames: bool = True) -> torch.Tensor:
    """The (F, H, W, 3) uint8 frames of a point light per frame, or with
    ``frames=False`` the lit mask (F, H, W) bool, from the trace kernel's
    winners: the winner-input point mode of the kernel, which derives each
    pixel's surface point and shadow ray itself and shades the pixel where
    it stores its lit bit, so no G-buffer or ray buffer exists.

    Arguments as :func:`ops.shade.point_frames`; the march is uncapped and
    covers the whole view, one block per (frame, bin-column tile, band of
    :func:`trace_cuda.band_rows` rows).  Raises ``ValueError`` for a tensor the
    kernel does not take and where a block's shared memory
    (:func:`shade_smem_bytes`: fixed but for V / 8 B of visit-list masks)
    would exceed MAX_SMEM, which at capacity 8 is a grid of more than
    353,568 bins.

    While a profiler records (``runtime/tracing.active``) the launch runs
    the kernel that counts its slab tests into ``counters``
    (``shade_slab_tests``) and adds its F * H * W pixels to
    ``counters.shade_pixels``; otherwise the kernel that does not count.
    """
    global shade_launches
    dev = bins_ent.device
    if dev.type == "cpu":
        return shade.point_frames(winner, pos, ext, sprite_id, atlas_color,
                                  atlas_depth, atlas_normal, palette,
                                  bins_ent, counts, players, lights, config,
                                  frames=frames)
    if dev.type != "cuda":
        raise ValueError(f"shade_point: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    atlas = (atlas_depth.shape[0], cfg.sprite_height, cfg.sprite_width)
    for t, name, dtype, shape in (
            (winner, "winner", torch.int32, (F, H, W)),
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (sprite_id, "sprite_id", torch.int32, (N,)),
            (atlas_color, "atlas_color", torch.int32, atlas),
            (atlas_depth, "atlas_depth", torch.int32, atlas),
            (atlas_normal, "atlas_normal", torch.float32, atlas + (3,)),
            (palette, "palette", torch.uint8, (None, 4)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (players, "players", torch.int32, (F, 3)),
            (lights, "lights", torch.int32, (F, 3))):
        kernels.require(t, name, dtype, shape, dev)
    chunk = shade_chunk(cfg)
    smem = shade_smem_bytes(cfg, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"shade_point: the visit-list masks of a {V}-bin "
                         f"grid and a band of {trace_cuda.band_rows(cfg)} rows "
                         f"of {cfg.bin_size} pixels need {smem} B of shared "
                         f"memory, over the {MAX_SMEM} B a block may use")

    out = torch.empty((F, H, W, 3) if frames else (F, H, W),
                      dtype=torch.uint8 if frames else torch.bool,
                      device=dev)
    r, g, b = cfg.background[:3]
    # Made at the first launch, so a traced launch adds no device operation.
    work = counters.work(dev)
    counting = tracing.active()
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_shade(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(), winner.data_ptr(),
            sprite_id.data_ptr(), atlas_depth.data_ptr(),
            atlas_color.data_ptr(), atlas_normal.data_ptr(),
            palette.data_ptr(), lights.data_ptr(),
            None if frames else out.data_ptr(),
            out.data_ptr() if frames else None,
            counters.tensor(dev).data_ptr(),
            work.data_ptr() if counting else None, F, W, H, cfg.bin_size,
            cap, cfg.hash_width, cfg.hash_height, cfg.hash_length,
            cfg.sprite_width, cfg.sprite_height, r, g, b, cfg.ambient,
            chunk, MARCH_THREADS, kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_shade")
    shade_launches += 1
    if counting:
        counters.shade_pixels += F * H * W
    return out


def shade_lights(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                 atlas_normal, palette, bins_ent, counts, players, lights,
                 config: RenderConfig) -> torch.Tensor:
    """The (F, H, W, 3) uint8 frames of L point lights per frame whose
    shadowed diffuse adds, from the trace kernel's winners, in one launch:
    the multi-light mode of the kernel, which decodes each pixel once,
    marches it toward each light in order (as :func:`shade_point` does for
    one: only where its colour can change), sums the lights' diffuse in
    float32 and stores the shaded pixel once, so no G-buffer, ray buffer,
    lit mask or factor exists.

    Arguments as :func:`ops.shade.light_frames`: lights (F, L, 3) int32,
    L >= 1.  The launch takes an (F, H, W) float32 scratch for the running
    sum where L > 1.  Raises ``ValueError`` as :func:`shade_point` does,
    and for L < 1.

    While a profiler records (``runtime/tracing.active``) the launch runs
    the kernel that counts its slab tests and pixel-lights marched into
    ``counters`` (``light_slab_tests``, ``light_marched_pixels``) and adds
    its F * H * W * L pixel-lights to ``counters.light_pixels``; otherwise
    the kernel that does not count.
    """
    global light_launches
    if lights.dim() != 3 or lights.shape[1] < 1:
        raise ValueError(f"shade_lights: lights of shape "
                         f"{tuple(lights.shape)}, expected (F, L, 3) with "
                         f"L >= 1")
    dev = bins_ent.device
    if dev.type == "cpu":
        return shade.light_frames(winner, pos, ext, sprite_id, atlas_color,
                                  atlas_depth, atlas_normal, palette,
                                  bins_ent, counts, players, lights, config)
    if dev.type != "cuda":
        raise ValueError(f"shade_lights: no kernel for device {dev}")

    cfg = config
    F, L = lights.shape[:2]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    atlas = (atlas_depth.shape[0], cfg.sprite_height, cfg.sprite_width)
    for t, name, dtype, shape in (
            (winner, "winner", torch.int32, (F, H, W)),
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (sprite_id, "sprite_id", torch.int32, (N,)),
            (atlas_color, "atlas_color", torch.int32, atlas),
            (atlas_depth, "atlas_depth", torch.int32, atlas),
            (atlas_normal, "atlas_normal", torch.float32, atlas + (3,)),
            (palette, "palette", torch.uint8, (None, 4)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (players, "players", torch.int32, (F, 3)),
            (lights, "lights", torch.int32, (F, L, 3))):
        kernels.require(t, name, dtype, shape, dev)
    chunk = shade_chunk(cfg)
    smem = shade_smem_bytes(cfg, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"shade_lights: the visit-list masks of a {V}-bin "
                         f"grid and a band of {trace_cuda.band_rows(cfg)} rows "
                         f"of {cfg.bin_size} pixels need {smem} B of shared "
                         f"memory, over the {MAX_SMEM} B a block may use")

    out = torch.empty((F, H, W, 3), dtype=torch.uint8, device=dev)
    sums = (torch.empty((F, H, W), dtype=torch.float32, device=dev)
            if L > 1 else None)
    r, g, b = cfg.background[:3]
    work = counters.work(dev)
    counting = tracing.active()
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_lights(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(), winner.data_ptr(),
            sprite_id.data_ptr(), atlas_depth.data_ptr(),
            atlas_color.data_ptr(), atlas_normal.data_ptr(),
            palette.data_ptr(), lights.data_ptr(),
            None if sums is None else sums.data_ptr(), out.data_ptr(),
            counters.tensor(dev).data_ptr(),
            work.data_ptr() if counting else None, F, L, W, H,
            cfg.bin_size, cap, cfg.hash_width, cfg.hash_height,
            cfg.hash_length, cfg.sprite_width, cfg.sprite_height, r, g, b,
            cfg.ambient, chunk, MARCH_THREADS, kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_lights")
    light_launches += 1
    if counting:
        counters.light_pixels += F * H * W * L
    return out


def trace_light_directional(pos, ext, bins_ent, counts, gbuf_y, gbuf_z,
                            start_ent, inv, K, players,
                            config: RenderConfig,
                            max_steps: int) -> torch.Tensor:
    """Lit mask (F, H, W) bool under a directional light per frame.

    Arguments as :func:`ops.shadow_dir.trace_light_directional`: the
    G-buffer's y, z and entity (F, H, W) int32, each frame's reciprocal
    direction ``inv`` (F, 3) float32 and far-light offsets ``K`` (F, 3)
    int32, and the step cap ``max_steps`` >= 0.  Raises ``ValueError``
    where the config's packed key does not fit
    (:func:`ops.shadow_dir.key_fields`), and ``RuntimeError`` where the
    launch fails, as it does for a grid whose key masks and union list
    (a word each per grid bin) overflow a block's shared memory.

    Each launch adds its slab tests (union lists and direct march) to
    ``counters`` and its F * H * W pixels to ``counters.dir_pixels``.
    """
    global directional_launches
    dev = bins_ent.device
    if dev.type == "cpu":
        return shadow_dir.trace_light_directional(
            pos, ext, bins_ent, counts, gbuf_y, gbuf_z, start_ent, inv, K,
            players, config, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"trace_light_directional: no kernel for device "
                         f"{dev}")

    cfg = config
    fields = shadow_dir.key_fields(cfg)
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    pixel = (F, H, W)
    for t, name, dtype, shape in (
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (players, "players", torch.int32, (F, 3)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (gbuf_y, "gbuf_y", torch.int32, pixel),
            (gbuf_z, "gbuf_z", torch.int32, pixel),
            (start_ent, "start_ent", torch.int32, pixel),
            (inv, "inv", torch.float32, (F, 3)),
            (K, "K", torch.int32, (F, 3))):
        kernels.require(t, name, dtype, shape, dev)
    if max_steps < 0:
        raise ValueError(f"trace_light_directional: max_steps {max_steps} "
                         f"< 0")
    packed = (ctypes.c_int * 10)(*(lo for lo, _ in fields),
                                 *(bits for _, bits in fields))

    lit = torch.empty(pixel, dtype=torch.bool, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_dir_lit(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(), gbuf_y.data_ptr(),
            gbuf_z.data_ptr(), start_ent.data_ptr(), inv.data_ptr(),
            K.data_ptr(), lit.data_ptr(), counters.tensor(dev).data_ptr(),
            counters.work(dev).data_ptr(), F, W, H, cfg.bin_size, cap,
            cfg.hash_width, cfg.hash_height, cfg.hash_length, max_steps,
            ctypes.addressof(packed), march_threads(cfg),
            kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_dir_lit")
    directional_launches += 1
    counters.dir_pixels += F * H * W
    return lit


def shade_directional(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                      atlas_normal, palette, palette_luma, bins_ent, counts,
                      players, tl, inv, K, config: RenderConfig,
                      style: str = "reference") -> torch.Tensor:
    """The (F, H, W, 3) uint8 frames of a directional light per frame, from
    the trace kernel's winners: the winner-input directional mode of the
    kernel, which decodes each pixel's surface, marches it as
    :func:`trace_light_directional` does and shades it (``style``
    "reference" or "dithered") where it stores, so no G-buffer, dot, lit
    mask or factor exists.

    Arguments as :func:`ops.shade.directional_frames`, and
    ``palette_luma`` (P,) float32, ``dither.luminance(palette[:, :3])``
    (``models/deferred.DeviceScene.palette_luma``), which the plain
    version computes itself.  Raises ``ValueError`` for a tensor the kernel
    does not take, another style, a sprite of NO_TEXEL texels or more, or
    a key the config cannot pack (:func:`ops.shadow_dir.key_fields`).

    Only the pixels whose colour the march can change are marched
    (``ops/shade.march_live``); the others settle at decode.  Each launch
    adds its slab tests (union lists and direct march) and its pixels
    marched (``dir_marched_pixels``) to ``counters`` and its F * H * W
    pixels to ``counters.dir_pixels`` and ``counters.dir_shade_pixels``.
    """
    global dir_shade_launches
    if style not in STYLES:
        raise ValueError(f"shade_directional: style {style!r}, expected one "
                         f"of {STYLES}")
    dev = bins_ent.device
    if dev.type == "cpu":
        return shade.directional_frames(winner, pos, ext, sprite_id,
                                        atlas_color, atlas_depth,
                                        atlas_normal, palette, bins_ent,
                                        counts, players, tl, inv, K, config,
                                        style)
    if dev.type != "cuda":
        raise ValueError(f"shade_directional: no kernel for device {dev}")

    cfg = config
    fields = shadow_dir.key_fields(cfg)
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    P = palette.shape[0]
    atlas = (atlas_depth.shape[0], cfg.sprite_height, cfg.sprite_width)
    for t, name, dtype, shape in (
            (winner, "winner", torch.int32, (F, H, W)),
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (sprite_id, "sprite_id", torch.int32, (N,)),
            (atlas_color, "atlas_color", torch.int32, atlas),
            (atlas_depth, "atlas_depth", torch.int32, atlas),
            (atlas_normal, "atlas_normal", torch.float32, atlas + (3,)),
            (palette, "palette", torch.uint8, (P, 4)),
            (palette_luma, "palette_luma", torch.float32, (P,)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (players, "players", torch.int32, (F, 3)),
            (tl, "tl", torch.float32, (F, 3)),
            (inv, "inv", torch.float32, (F, 3)),
            (K, "K", torch.int32, (F, 3))):
        kernels.require(t, name, dtype, shape, dev)
    if cfg.sprite_width * cfg.sprite_height >= NO_TEXEL:
        raise ValueError(f"shade_directional: a sprite of "
                         f"{cfg.sprite_width} x {cfg.sprite_height} texels, "
                         f"the kernel's 16-bit offsets hold fewer than "
                         f"{NO_TEXEL}")
    packed = (ctypes.c_int * 10)(*(lo for lo, _ in fields),
                                 *(bits for _, bits in fields))
    r, g, b = cfg.background[:3]

    out = torch.empty((F, H, W, 3), dtype=torch.uint8, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_dir_shade(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(), winner.data_ptr(),
            sprite_id.data_ptr(), atlas_depth.data_ptr(),
            atlas_color.data_ptr(), atlas_normal.data_ptr(),
            palette.data_ptr(), palette_luma.data_ptr(), tl.data_ptr(),
            inv.data_ptr(), K.data_ptr(), out.data_ptr(),
            counters.tensor(dev).data_ptr(), counters.work(dev).data_ptr(),
            F, W, H, cfg.bin_size, cap,
            cfg.hash_width, cfg.hash_height, cfg.hash_length,
            shadow_dir.grid_max_steps(cfg), cfg.sprite_width,
            cfg.sprite_height, r, g, b, P, int(style == "dithered"),
            cfg.ambient, dither.color_luminance((r, g, b)),
            ctypes.addressof(packed), march_threads(cfg),
            kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_dir_shade")
    dir_shade_launches += 1
    counters.dir_pixels += F * H * W
    counters.dir_shade_pixels += F * H * W
    return out


def occupancy(config: RenderConfig) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of the G-buffer point mode, at its chunk and
    threads (needs the card)."""
    return kernels.occupancy("par_shadow_occupancy", config,
                             MARCH_THREADS, shade_chunk(config))


def shade_occupancy(config: RenderConfig,
                    counting: bool = False) -> tuple[int, ...]:
    """The same for the winner-input point mode, at its chunk and
    threads; with ``counting``, of the kernel that counts its work (the
    one :func:`shade_point` launches while the program is traced)."""
    return kernels.occupancy("par_shadow_shade_occupancy", config,
                             MARCH_THREADS, shade_chunk(config),
                             int(counting))


def lights_occupancy(config: RenderConfig,
                     counting: bool = False) -> tuple[int, ...]:
    """The same for the multi-light mode (:func:`shade_lights`)."""
    return kernels.occupancy("par_shadow_lights_occupancy", config,
                             MARCH_THREADS, shade_chunk(config),
                             int(counting))


def directional_occupancy(config: RenderConfig) -> tuple[int, ...]:
    """The same for the directional mode."""
    return kernels.occupancy("par_shadow_dir_occupancy", config,
                             march_threads(config))


def directional_shade_occupancy(config: RenderConfig) -> tuple[int, ...]:
    """The same for the winner-input directional mode."""
    return kernels.occupancy("par_shadow_dir_shade_occupancy", config,
                             march_threads(config))
