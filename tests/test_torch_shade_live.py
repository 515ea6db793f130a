"""The march's live set in the winner-input point mode's frames store.

Where ``ops/shade.point_frames`` (and the kernel it is the plain version
of, ``csrc/shadow.cu``'s winner-input point mode) stores frames, a pixel
whose factor lit equals its factor occluded has the same colour either
way: it is settled, and only the other pixels are marched
(``shade.march_live``).  On the CPU: the frames with settled pixels equal
the full march's bit for bit on two scenes with background, faces turned
from the light, a light on a surface point (NaN dot) and a light inside a
tile, at ambient 0.25, 1.0 (every pixel settles) and 1.5 (none does);
``work["marched_pixels"]`` and ``work["slab_tests"]`` equal a direct count
over the live pixels; and the lit mask marches every pixel.  The CUDA
cases (skipped without a card) hold the kernel's frames to the plain
version and to the full march's on graybox's three orbits and config 5,
its counters to the plain counts, an all-background batch to no list and
a key-table overflow to a direct march of its live pixels, and the
lit-mask modes to today's counts.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, RenderConfig,
                                           SceneBuilder, default_light,
                                           demo_world, graybox_world)
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import (fused_cuda, shade, shadow,
                                               shadow_cuda, trace)
from pixel_art_raytracer_tpu_torch.ops.cstyle import c_max, c_min
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.time_kernels import config5_winners

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
# Bins of 10 over a deeper view: a tile's surfaces lie in many z bins, so
# some bands hold more start bins than the march's table.
FINE = dataclasses.replace(SMALL, view_length=160, bin_size=10)
AMBIENTS = (0.25, 1.0, 1.5)
LIGHT_CASES = ("ordinary", "on_surface", "inside_tile", "behind_faces")
# Lights above and in front of the deep scene, which light most top and
# front faces, so the live pixels keep many start bins a band.
DEEP_LIGHTS = [[40, 200, -150], [30, 250, -100]]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def boxes_scene(config):
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def deep_scene(config=FINE, seed=3):
    """A player box and seeded small boxes spread over the whole depth."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (10, 10, 10))
    for _ in range(160):
        b.insert((int(rng.integers(0, 76)), int(rng.integers(0, 60)),
                  int(rng.integers(0, 150))),
                 tuple(int(v) for v in rng.integers(3, 11, 3)))
    return b.build()


SCENES = {
    "boxes": boxes_scene,
    "demo": lambda config: demo_world(3, config),
}


def winner_args(scene, config, device="cpu", frames=3, seed=0):
    """``shade_point``'s arguments on ``scene``: ``frames`` states with a
    moving player, the trace's winners, and placeholder lights (row 11)."""
    r = DeferredRenderer(config).configure_for(scene)
    ds = DeviceScene.from_scene(scene, config, device=device)
    cache = StaticBins(scene.pos, scene.ext, 1, config, r.spans,
                       device=device)
    rng = np.random.default_rng(seed)
    players = torch.from_numpy((scene.pos[0] + rng.integers(
        -10, 11, (frames, 3))).astype(np.int32)).to(device)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    lights = torch.zeros((frames, 3), dtype=torch.int32, device=device)
    return [winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, config]


def case_lights(case, args):
    """(F, 3) int32 lights of one case, from the frames' surfaces."""
    winners, pos, ext, sprite_id, _, atlas_depth = args[:6]
    players, cfg = args[10], args[12]
    F = winners.shape[0]
    if case == "ordinary":
        rows = [[60, 60, 20], [10, 70, 5], [70, 45, 35]]
    elif case == "behind_faces":
        # Below every top face and behind every front face.
        rows = [[40, -30, 300], [0, -1, 250], [79, -60, 400]]
    elif case in ("on_surface", "inside_tile"):
        y, z, _, _ = trace.decode_winner(winners, pos, ext, sprite_id,
                                         atlas_depth, players, cfg)
        rows = []
        for f in range(F):
            hit = torch.nonzero(winners[f] >= 0)
            j, i = (int(v) for v in hit[len(hit) // 2])
            p = [i, int(y[f, j, i]), int(z[f, j, i])]
            if case == "inside_tile":
                # A few pixels off that surface point, in its bin: the
                # pixels of that start bin march no step.
                p = [i + 2 - i % 3, p[1] + 1, p[2] + 1]
            rows.append(p)
    else:
        raise ValueError(case)
    return torch.tensor(rows[:F], dtype=torch.int32,
                        device=winners.device)


def geometry(args):
    """Each pixel's Lambert dot, lit mask of the full march, and shadow-ray
    inputs, as the plain chain computes them."""
    winners, pos, ext, sprite_id, atlas_color, atlas_depth, atlas_normal, \
        palette, be, cnt, players, lights, cfg = args
    y, z, ent, texel = trace.decode_winner(winners, pos, ext, sprite_id,
                                           atlas_depth, players, cfg)
    surface = trace.GBufferArrays(normal=None, color=None, y=y, z=z,
                                  entity_index=ent)
    tl, inv, origin, rb, lb = shade.light_geometry(surface, lights, cfg)
    color, normal = trace.texel_attributes(winners >= 0, texel, atlas_color,
                                           atlas_normal, palette, cfg)
    dot = shade.lambert_dot(normal, tl)
    rays = (pos, ext, be, cnt, rb, lb, ent, origin, inv, players, cfg)
    return color, dot, rays


def full_march_frames(args):
    """The frames of the chain that marches every pixel."""
    color, dot, rays = geometry(args)
    lit = shadow.trace_light_dynamic(*rays)
    return shade.shade_u8(color, shade.factor_from_dot(dot, lit, args[-1]))


def ray_tests(rays):
    """Each ray's slab tests in the full march, counted ray by ray: at its
    first probe of each bin, up to its first occluder."""
    pos, ext, be, cnt, rb, lb, ent, origin, inv, players, cfg = rays
    shape = rb[0].shape
    F, V, cap = be.shape
    frame = torch.arange(F)[:, None, None]
    rows = torch.arange(rb[0].numel())
    seen = torch.zeros((rb[0].numel(), V + 1), dtype=torch.bool)
    occluded = torch.zeros(shape, dtype=torch.bool)
    tests = torch.zeros(shape, dtype=torch.int64)
    for flat, probe in shadow.dda_probes(rb, lb, cfg):
        col = torch.where(probe, flat, V).long().reshape(-1)
        first = probe & ~seen[rows, col].view(shape)
        seen[rows, col] = True
        flat_c = torch.where(probe, flat, 0).long()
        n = cnt[frame, flat_c]
        for k in range(cap):
            e = be[frame, flat_c, k]
            test = probe & ~occluded & (k < n) & (e != ent)
            tests += (test & first).long()
            es = torch.where(e >= 0, e, 0).long()
            lo = trace.entity_pos(pos, players, es).to(torch.float32)
            hi = lo + ext[es].to(torch.float32)
            near, far = None, None
            for a in range(3):
                t1 = (lo[..., a] - origin[a]) * inv[a]
                t2 = (hi[..., a] - origin[a]) * inv[a]
                near = c_min(t1, t2) if near is None else c_max(
                    near, c_min(t1, t2))
                far = c_max(t1, t2) if far is None else c_min(
                    far, c_max(t1, t2))
            occluded |= test & (far >= near)
    return tests


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("case", LIGHT_CASES)
@pytest.mark.parametrize("ambient", AMBIENTS)
def test_settled_frames_equal_the_full_march(scene, case, ambient):
    cfg = dataclasses.replace(SMALL, ambient=ambient)
    args = winner_args(SCENES[scene](cfg), cfg)
    args[11] = case_lights(case, args)
    _, dot, _ = geometry(args)
    live = shade.march_live(dot, cfg)
    hit = args[0] >= 0
    assert bool((~hit).any())  # background in the view
    if case == "on_surface":
        assert bool(torch.isnan(dot).any())
    if case == "behind_faces":
        assert bool((dot[hit] <= 0).all())
    else:
        assert bool((dot[hit] > 0).any()) and bool((dot[hit] <= 0).any())
    if ambient == 1.0:
        assert not bool(live.any())
    elif ambient == 1.5:
        assert bool(live.all())
    else:
        # Background, NaN dots and faces turned away settle; the rest not.
        assert torch.equal(live, hit & (dot > 0))
    work = {}
    got = shade.point_frames(*args, work=work)
    assert torch.equal(got, full_march_frames(args))
    assert int(work["marched_pixels"]) == int(live.sum())


def live_start_bins_per_band(args):
    """The most distinct start bins of the live pixels of one band of the
    point march (a bin-column tile; FINE's bands are whole tiles)."""
    cfg = args[-1]
    bs = cfg.bin_size
    winners, pos, ext, sprite_id, _, atlas_depth = args[:6]
    y, z, _, _ = trace.decode_winner(winners, pos, ext, sprite_id,
                                     atlas_depth, args[10], cfg)
    _, dot, _ = geometry(args)
    live = shade.march_live(dot, cfg)
    F, H, W = winners.shape
    keys = torch.stack([torch.arange(W).expand(F, H, W) // bs,
                        (cfg.view_height - y - z) // bs, z // bs], -1)
    tile = (torch.arange(F)[:, None, None] * (H // bs) * (W // bs)
            + torch.arange(H)[None, :, None] // bs * (W // bs)
            + torch.arange(W)[None, None, :] // bs).expand(F, H, W)
    return max(len(torch.unique(keys[live & (tile == t)], dim=0))
               for t in tile.unique())


def test_deep_scene_live_pixels_overflow_the_start_table():
    args = winner_args(deep_scene(), FINE, frames=2)
    args[11] = torch.tensor(DEEP_LIGHTS, dtype=torch.int32)
    assert FINE.bin_size ** 2 <= 1600  # a band is a whole tile
    assert live_start_bins_per_band(args) > shadow_cuda.STARTS


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("case", ["ordinary", "inside_tile"])
def test_counts_are_the_live_pixels(scene, case):
    args = winner_args(SCENES[scene](SMALL), SMALL)
    args[11] = case_lights(case, args)
    _, dot, rays = geometry(args)
    live = shade.march_live(dot, SMALL)
    per_ray = ray_tests(rays)
    assert bool(live.any()) and int(per_ray[~live].sum()) > 0
    work = {}
    shade.point_frames(*args, work=work)
    assert int(work["marched_pixels"]) == int(live.sum())
    assert int(work["slab_tests"]) == int(per_ray[live].sum())
    # The lit mask marches every pixel.
    work = {}
    lit = shade.point_frames(*args, frames=False, work=work)
    assert torch.equal(lit, shadow.trace_light_dynamic(*rays))
    assert int(work["marched_pixels"]) == live.numel()
    assert int(work["slab_tests"]) == int(per_ray.sum())


# -- on the card -------------------------------------------------------------


def graybox_orbit(device, orbit, frames):
    cfg = DEFAULT_CONFIG
    scene = graybox_world(cfg)
    r = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device=device)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg, device=device)
    light = default_light(cfg)
    center = {"center": (light.x, light.y, light.z),
              "edge_x": (20, light.y, light.z),
              "edge_z": (light.x, light.y, 280)}[orbit]
    players, lights = anim.light_sweep_states(frames, scene.pos[0],
                                              center=center, radius=40,
                                              device=device)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    return (winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, cfg)


def counted(args, frames=True):
    """One traced ``shade_point`` launch: its output and counters."""
    shadow_cuda.counters.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = shadow_cuda.shade_point(*args, frames=frames)
    torch.cuda.synchronize()
    return out, shadow_cuda.counters.read()


def frames_match_and_count(args):
    """The kernel's frames equal the plain version's and the full march's
    (from the lit-mask kernel), and its counted work the plain counts;
    returns the counters."""
    got = shadow_cuda.shade_point(*args)
    torch.cuda.synchronize()
    work = {}
    want = shade.point_frames(*args, work=work)
    assert torch.equal(got, want)
    lit = shadow_cuda.shade_point(*args, frames=False)
    color, dot, _ = geometry(args)
    assert torch.equal(got, shade.shade_u8(
        color, shade.factor_from_dot(dot, lit, args[-1])))
    again, c = counted(args)
    assert torch.equal(again, got)
    assert c["shade_marched_pixels"] == int(work["marched_pixels"])
    if c["direct_pixels"] == 0:
        assert c["shade_slab_tests"] == int(work["slab_tests"])
    else:
        # The direct march tests again at a repeated probe.
        assert (int(work["slab_tests"]) <= c["shade_slab_tests"]
                <= int(work["slab_tests_every_probe"]))
    assert c["shade_pixels"] == got[..., 0].numel()
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("orbit", ["center", "edge_x", "edge_z"])
def test_cuda_frames_march_the_live_pixels_on_graybox(cuda, orbit):
    c = frames_match_and_count(graybox_orbit(cuda, orbit, 64))
    assert 0 < c["shade_marched_pixels"] < c["shade_pixels"]


@pytest.mark.cuda
@pytest.mark.parametrize("factor,frames", [(2, 8), (4, 2)])
def test_cuda_frames_march_the_live_pixels_on_config5(cuda, factor, frames):
    c = frames_match_and_count(config5_winners(factor, frames))
    assert 0 < c["shade_marched_pixels"] < c["shade_pixels"] // 2


@pytest.mark.cuda
def test_cuda_all_background_batch_lists_nothing(cuda):
    args = list(graybox_orbit(cuda, "center", 4))
    args[0] = torch.full_like(args[0], -1)
    c = frames_match_and_count(args)
    assert c["shade_marched_pixels"] == 0 and c["shade_slab_tests"] == 0
    assert (c["direct_pixels"], c["max_starts"], c["max_list"]) == (0, 0, 0)


@pytest.mark.cuda
def test_cuda_table_overflow_marches_its_live_direct_pixels(cuda):
    args = winner_args(deep_scene(), FINE, cuda, frames=2)
    args[11] = torch.tensor(DEEP_LIGHTS, dtype=torch.int32, device=cuda)
    c = frames_match_and_count(args)
    assert c["max_starts"] == shadow_cuda.STARTS + 1
    assert 0 < c["direct_pixels"] < c["shade_marched_pixels"]


@pytest.mark.cuda
def test_cuda_lit_mask_modes_keep_their_counts(cuda):
    """The lit-mask stores march every pixel: the winner-input mode's lit
    mask, the G-buffer point mode and the fused kernel list each key's
    whole visit list, and agree on every counter."""
    args = graybox_orbit(cuda, "edge_x", 16)
    cfg = args[-1]
    _, _, rays = geometry(args)
    lit, c = counted(args, frames=False)
    work = {}
    assert torch.equal(lit, shadow.trace_light_dynamic(*rays, work=work))
    assert c["shade_marched_pixels"] == c["shade_pixels"] == lit.numel()
    assert c["shade_slab_tests"] == int(work["slab_tests"])
    shadow_cuda.counters.reset()
    assert torch.equal(shadow_cuda.trace_light(*rays), lit)
    gbuffer = shadow_cuda.counters.read()
    fused_cuda.counters.reset()
    winners, pos, ext, sprite_id, _, atlas_depth = args[:6]
    _, win_f, lit_f = fused_cuda.trace_shadow(
        pos, ext, sprite_id, atlas_depth, args[8], args[9], args[10],
        args[11], cfg)
    torch.cuda.synchronize()
    assert torch.equal(win_f, winners) and torch.equal(lit_f, lit)
    fused = fused_cuda.counters.read()
    rb, lb = rays[4], rays[5]
    keys = torch.stack([t.expand(rb[0].shape).reshape(-1)
                        for t in (*rb, *lb)], dim=1).unique(dim=0).cpu()
    _, first = shadow.dda_first_visits(tuple(keys[:, :3].unbind(1)),
                                       tuple(keys[:, 3:].unbind(1)), cfg)
    longest = int(first.sum(0).max())
    for k in ("direct_pixels", "max_starts", "max_list"):
        assert c[k] == gbuffer[k] == fused[k], k
    assert c["max_list"] == longest
