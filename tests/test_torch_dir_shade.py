"""The winner-input directional mode of ``csrc/shadow.cu``: the frames of a
directional light per frame straight from the trace kernel's winners.

On the CPU its plain version (``ops/shade.directional_frames``) equals the
G-buffer route's frames (``batched.gbuffer_and_frames(...,
directional=True)``) in both styles, on scenes with background pixels and
frames whose direction lies along a plane (an infinite reciprocal
component), and ``render_states(..., directional=True)`` takes it: the
winners, then the mode, with no G-buffer, lit-mask launch or dither call
outside the plain version.  It marches only the pixels whose colour the
march can change (``shade.march_live`` of the dot against the frame's
direction), and its frames still equal the route's, which marches every
pixel, at ambient 0.25, 1.0 (every pixel settles) and 1.5 (none does).
The CUDA-marked tests hold the kernel's frames to the plain version and
to the G-buffer route bit for bit (BASELINE config 4's 512 x 512 overlap
scene, whose tiles hold more live keys than the table, so some pixels
march directly; graybox's sweep; directions along planes; the three
ambients), its marched pixels to the plain count, count one batch's
launches, pixels and spans, and pin both directional modes' layouts.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, demo_world,
                                           graybox_world)
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import (binning_cuda, dither, shade,
                                               shadow_cuda, shadow_dir, trace,
                                               trace_cuda)
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from port_bench import program, spec
from test_torch_tracing import SMALL, small_scene, span_tree

STYLES = ["reference", "dithered"]
# Frame 0 faces along (1, 1, 0) and frame 1 along (0, 1, 0): reciprocal
# directions infinite in z, and in x and z.  Frames 2-3 lie off every
# plane.
DIRECTIONS = np.float32([[1.0, 1.0, 0.0], [0.0, 1.0, 0.0],
                         [0.3, 1.0, -0.2], [-1.0, 0.8, 0.5]])
SCENES = {"small": small_scene, "demo": lambda: demo_world(4, SMALL)}
AMBIENTS = (0.25, 1.0, 1.5)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sun_sweep(n: int) -> np.ndarray:
    """(n, 3) float32 directions toward the sun, (cos t, 1, 0.5 sin t) for
    t = 2 pi f / n (``chip_smoke.py``'s sweep)."""
    t = 2.0 * np.pi * np.arange(n) / n
    return np.stack([np.cos(t), np.ones(n), 0.5 * np.sin(t)],
                    -1).astype(np.float32)


def request(scene, config, style, directions, device, seed=0):
    """``(renderer, device scene, bin cache, players, directions)``: the
    player moved by a seeded step in each frame."""
    r = DeferredRenderer(config, style=style).configure_for(scene)
    ds = DeviceScene.from_scene(scene, config, device=device)
    cache = StaticBins(scene.pos, scene.ext, 1, config, r.spans,
                       device=device)
    rng = np.random.default_rng(seed)
    F = len(directions)
    players = (scene.pos[0] + rng.integers(-4, 5, (F, 3))).astype(np.int32)
    return (r, ds, cache, torch.from_numpy(players).to(device),
            torch.from_numpy(directions).to(device))


def mode_args(r, ds, cache, players, directions):
    """The arguments of ``shade.directional_frames`` for the request, but
    the style."""
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    tl, inv, K = shadow_dir.direction_constants(directions, r.config)
    return (winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            tl, inv, K, r.config)


def kernel_frames(ds, args, style):
    """``shadow_cuda.shade_directional`` on ``mode_args``' arguments."""
    return shadow_cuda.shade_directional(*args[:8], ds.palette_luma,
                                         *args[8:], style)


def route_frames(r, ds, cache, players, directions):
    return batched.gbuffer_and_frames(r, cache, ds, players, directions,
                                      directional=True)[1]


def live_pixels(args):
    """``(live, dot, hit)`` of ``mode_args``' arguments: the pixels whose
    colour the march can change (``shade.march_live``), the Lambert dot
    against each frame's direction and where the view hits a surface."""
    winners, pos, ext, sprite_id, atlas_color, atlas_depth, atlas_normal, \
        palette, _, _, players, tl, _, _, cfg = args
    _, _, _, texel = trace.decode_winner(winners, pos, ext, sprite_id,
                                         atlas_depth, players, cfg)
    hit = winners >= 0
    _, normal = trace.texel_attributes(hit, texel, atlas_color,
                                       atlas_normal, palette, cfg)
    F = tl.shape[0]
    dot = shade.lambert_dot(normal, tuple(tl[:, a].view(F, 1, 1)
                                          for a in range(3)))
    return shade.march_live(dot, cfg), dot, hit


# -- the plain version --------------------------------------------------------

@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_plain_version_equals_the_gbuffer_route(scene_name, style):
    req = request(SCENES[scene_name](), SMALL, style, DIRECTIONS, "cpu")
    args = mode_args(*req)
    got = shade.directional_frames(*args, style=style)
    assert got.shape == (len(DIRECTIONS), 80, 80, 3)
    assert torch.equal(got, route_frames(*req))
    # Background pixels, and frames along a plane and off every plane.
    winners, inv = args[0], args[12]
    assert (winners < 0).any() and (winners >= 0).any()
    assert not inv[0].isfinite().all() and not inv[1].isfinite().all()
    assert inv[2:].isfinite().all()
    if style == "dithered":
        palette = {tuple(c) for c in SMALL.palette_array[:, :3].tolist()}
        assert {tuple(c) for c in got.reshape(-1, 3).tolist()} <= palette


@pytest.mark.parametrize("ambient", AMBIENTS)
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_plain_version_marches_only_live_pixels(scene_name, style, ambient):
    """Background pixels and faces turned from the sun (a dot <= 0 or NaN)
    settle at ambient <= 1, every pixel at ambient 1 and none at 1.5; the
    plain version marches only the rest, and its frames equal the G-buffer
    route's, which marches every pixel."""
    cfg = dataclasses.replace(SMALL, ambient=ambient)
    req = request(SCENES[scene_name](), cfg, style, DIRECTIONS, "cpu")
    args = mode_args(*req)
    live, dot, hit = live_pixels(args)
    work = {}
    got = shade.directional_frames(*args, style=style, work=work)
    assert torch.equal(got, route_frames(*req))
    assert int(work["marched_pixels"]) == int(live.sum())
    assert bool((~hit).any())
    if ambient == 1.0:
        assert not bool(live.any()) and int(work["slab_tests"]) == 0
    elif ambient == 1.5:
        assert bool(live.all())
    else:
        assert torch.equal(live, hit & (dot > 0))
        assert bool((hit & (dot <= 0)).any()) and bool(live.any())
        # The settled pixels' tests are gone from the count.
        winners, pos, ext, sprite_id, _, atlas_depth = args[:6]
        be, cnt, players, _, inv, K = args[8:14]
        y, z, ent, _ = trace.decode_winner(winners, pos, ext, sprite_id,
                                           atlas_depth, players, cfg)
        full = {}
        shadow_dir.trace_light_directional(
            pos, ext, be, cnt, y, z, ent, inv, K, players, cfg,
            shadow_dir.grid_max_steps(cfg), work=full)
        assert int(work["slab_tests"]) < int(full["slab_tests"])


def test_render_states_shades_from_the_winners(monkeypatch):
    """A dithered directional batch calls the trace kernel's wrapper and
    the winner-input directional mode's once each, and no G-buffer, no
    lit-mask march and no dither outside the mode's plain version."""
    req = request(SCENES["demo"](), SMALL, "dithered", DIRECTIONS, "cpu")
    r, ds, cache, players, directions = req
    want = route_frames(*req)
    inside = [False]
    calls = {"trace_winners": 0, "shade_directional": 0}

    def forbid(name, fn):
        def guarded(*a, **k):
            if not inside[0]:
                raise AssertionError(f"{name} called on the main path")
            return fn(*a, **k)
        return guarded

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    plain = shade.directional_frames

    def in_plain(*a, **k):
        inside[0] = True
        try:
            return plain(*a, **k)
        finally:
            inside[0] = False

    monkeypatch.setattr(trace, "materialize_gbuffer",
                        forbid("materialize_gbuffer",
                               trace.materialize_gbuffer))
    monkeypatch.setattr(shadow_cuda, "trace_light_directional",
                        forbid("trace_light_directional",
                               shadow_cuda.trace_light_directional))
    monkeypatch.setattr(dither, "shade_dithered",
                        forbid("shade_dithered", dither.shade_dithered))
    monkeypatch.setattr(shade, "directional_frames", in_plain)
    monkeypatch.setattr(trace_cuda, "trace_winners",
                        counted("trace_winners", trace_cuda.trace_winners))
    monkeypatch.setattr(shadow_cuda, "shade_directional",
                        counted("shade_directional",
                                shadow_cuda.shade_directional))
    assert batched.winner_inputs(r, directions, True)
    got = AnimationRenderer(r, SMALL, static_bins=cache).render_states(
        ds, players, directions, directional=True)
    assert calls == {"trace_winners": 1, "shade_directional": 1}
    assert torch.equal(got, want)


def test_mode_refuses_another_style():
    req = request(SCENES["small"](), SMALL, "reference", DIRECTIONS[:1],
                  "cpu")
    with pytest.raises(ValueError, match="style"):
        kernel_frames(req[1], mode_args(*req), "sepia")


def test_luminance_tables():
    """The mode's tables: the palette's luminance, computed once per
    device scene, and the background's, on the host; each equals
    ``dither.luminance`` of the colours."""
    ds = DeviceScene.from_scene(SCENES["small"](), SMALL, device="cpu")
    luma = ds.palette_luma
    assert ds.palette_luma is luma and luma.dtype == torch.float32
    assert torch.equal(luma, dither.luminance(ds.palette[:, :3]))
    bg = SMALL.background[:3]
    assert dither.color_luminance(bg) == float(dither.luminance(
        torch.tensor([bg], dtype=torch.uint8))[0])


# -- on the card -------------------------------------------------------------

def config4():
    """BASELINE config 4 at its published 512 x 512: the benchmark's
    ``config4`` scene (config 3's overlap scene) and render config."""
    cell = spec.make_cell("config4.sun64", "config4", "sun64", 1,
                          json.loads(spec.BENCHMARK.read_text()))
    return (program.scene(cell.scene()),
            program.render_config(cell.config))


@functools.cache
def scene_and_config(case):
    """(scene, config, directions): directions along planes on a small
    view; config 4's sun sweep, whose tiles hold up to 21 keys; graybox's
    sweep."""
    if case == "planes":
        return demo_world(4, SMALL), SMALL, DIRECTIONS
    if case == "config4":
        return (*config4(), sun_sweep(64))
    return graybox_world(DEFAULT_CONFIG), DEFAULT_CONFIG, sun_sweep(8)


@pytest.mark.cuda
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("case", ["config4", "graybox", "planes"])
def test_cuda_mode_equals_plain_and_gbuffer_route(cuda, case, style):
    scene, config, directions = scene_and_config(case)
    req = request(scene, config, style, directions, cuda)
    args = mode_args(*req)
    shadow_cuda.counters.reset()
    n = shadow_cuda.dir_shade_launches
    got = kernel_frames(req[1], args, style)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    assert shadow_cuda.dir_shade_launches == n + 1
    assert torch.equal(got, shade.directional_frames(*args, style=style))
    assert torch.equal(got, route_frames(*req))
    n_pix = got.shape[0] * config.view_height * config.view_width
    assert stats["dir_pixels"] == stats["dir_shade_pixels"] == n_pix
    assert stats["slab_tests"] > 0
    if case == "config4":
        # Tiles with more live keys than the table (the live pixels' keys
        # of tile_unions): their pixels march directly.
        live, _, _ = live_pixels(args)
        y, z = trace.decode_winner(*args[:4], args[5], args[10],
                                   config)[:2]
        keys = shadow_dir.tile_unions(y, z, args[13], config,
                                      shadow_dir.grid_max_steps(config),
                                      live=live)["keys"]
        assert keys > shadow_dir.TABLE_KEYS
        assert stats["max_starts"] == shadow_dir.TABLE_KEYS + 1
        assert 0 < stats["direct_pixels"] < n_pix // 100


@pytest.mark.cuda
@pytest.mark.parametrize("ambient", AMBIENTS)
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("case", ["config4", "planes"])
def test_cuda_mode_marches_only_live_pixels(cuda, case, style, ambient):
    """At ambient 0.25, 1.0 (every pixel settles) and 1.5 (none does) the
    kernel's frames equal the plain version's and the G-buffer route's,
    and it marches the plain version's live pixels."""
    scene, config, directions = scene_and_config(case)
    config = dataclasses.replace(config, ambient=ambient)
    req = request(scene, config, style, directions, cuda)
    args = mode_args(*req)
    live, _, _ = live_pixels(args)
    shadow_cuda.counters.reset()
    got = kernel_frames(req[1], args, style)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    work = {}
    assert torch.equal(got, shade.directional_frames(*args, style=style,
                                                     work=work))
    assert torch.equal(got, route_frames(*req))
    assert stats["dir_marched_pixels"] == int(work["marched_pixels"]) \
        == int(live.sum())
    if ambient == 1.0:
        assert stats["dir_marched_pixels"] == 0
    elif ambient == 1.5:
        assert stats["dir_marched_pixels"] == got[..., 0].numel()


@pytest.mark.cuda
def test_cuda_batch_that_settles_every_pixel(cuda):
    """At ambient 1 every pixel's colour is the same lit or occluded: no
    tile keys, lists, stages or marches a pixel, and the frames are the
    plain version's."""
    scene, config, directions = scene_and_config("graybox")
    config = dataclasses.replace(config, ambient=1.0)
    req = request(scene, config, "dithered", directions, cuda)
    args = mode_args(*req)
    shadow_cuda.counters.reset()
    got = kernel_frames(req[1], args, "dithered")
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    assert torch.equal(got, shade.directional_frames(*args,
                                                     style="dithered"))
    assert {k: stats[k] for k in ("direct_pixels", "max_starts", "max_list",
                                  "staged_entries", "slab_tests",
                                  "dir_marched_pixels")} == \
        dict.fromkeys(("direct_pixels", "max_starts", "max_list",
                       "staged_entries", "slab_tests",
                       "dir_marched_pixels"), 0)
    assert stats["dir_shade_pixels"] == got[..., 0].numel()


@pytest.mark.cuda
def test_cuda_batch_launches_trace_and_the_mode_once(cuda):
    req = request(SCENES["demo"](), SMALL, "dithered", DIRECTIONS, cuda)
    r, ds, cache, players, directions = req
    want = route_frames(*req)
    anim = AnimationRenderer(r, SMALL, static_bins=cache)
    anim.render_states(ds, players, directions, directional=True)
    counts = (trace_cuda.launches, shadow_cuda.directional_launches,
              shadow_cuda.dir_shade_launches, shadow_cuda.shade_launches,
              shadow_cuda.launches, binning_cuda.merge_launches)
    shadow_cuda.counters.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = anim.render_states(ds, players, directions, directional=True)
        torch.cuda.synchronize()
    assert (trace_cuda.launches - counts[0],
            shadow_cuda.directional_launches - counts[1],
            shadow_cuda.dir_shade_launches - counts[2],
            shadow_cuda.shade_launches - counts[3],
            shadow_cuda.launches - counts[4],
            binning_cuda.merge_launches - counts[5]) == (1, 0, 1, 0, 0, 1)
    assert shadow_cuda.counters.read()["dir_shade_pixels"] == got.shape[0] \
        * SMALL.view_height * SMALL.view_width
    # No G-buffer, dither, upload of the background colour, or upload of
    # the merge's offsets (the merge kernel has none).
    assert span_tree(prof) == [
        ("batch", [("batch.bins", []), ("batch.trace", []),
                   ("batch.shade", [])])]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_directional_layouts(cuda):
    """The lit-mask mode keeps its layout (33,848 B, 4 blocks per SM and 48
    registers on graybox); the winner-input mode adds 10 B a pixel of a
    tile and keeps 4 blocks per SM on graybox and config 4."""
    assert shadow_cuda.directional_occupancy(DEFAULT_CONFIG)[:3] == (
        33848, 4, 48)
    for cfg, lit_smem in ((DEFAULT_CONFIG, 33848), (config4()[1], 38520)):
        smem, blocks, regs, _ = shadow_cuda.directional_shade_occupancy(cfg)
        assert smem == lit_smem + 10 * cfg.bin_size ** 2
        assert blocks == 4 and 0 < regs <= 255
