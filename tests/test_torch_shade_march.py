"""The point march (``csrc/common.cuh`` march_band) as ``csrc/shadow.cu``'s
winner-input point mode runs it: one block per (frame, bin-column tile,
band of rows), each pixel decoded once into the band's shared memory,
visit lists streamed a chunk at a time with a V-bit mask per key instead
of a list of V entries.

On the CPU: the Python mirror of the kernel's shared memory
(``shadow_cuda.shade_smem_bytes``) fits a block on graybox, on config 5 at
s = 2 and 4 and on a 52 x 52 x 8 grid, and grows with the grid's volume V
by the masks' V / 8 bytes alone; the bands cover each tile; and the plain
version (``ops/shade.point_frames``) equals the G-buffer chain and the C++
oracle on a grid of more than 12,800 bins, which the kernel used to refuse.
The CUDA cases (skipped without a card) hold the kernel to its plain
version on graybox's three orbits, on graybox at bins of 48 pixels (bands
of 33 and 15 rows), on a 21,632-bin grid, and pin its blocks per SM.
"""

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, Light,
                                           RenderConfig, default_light,
                                           demo_world, graybox_world)
from pixel_art_raytracer_tpu_torch import bench_scale
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.supersample import scaled_config
from pixel_art_raytracer_tpu_torch.ops import shade, shadow_cuda, trace_cuda
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import native

# The configurations the kernel runs: graybox, config 5 at s = 2 and 4
# (26 x 26 x 8 bins of 80 and 160 pixels), and a 2048**2 view at bin 40
# (52 x 52 x 8 = 21,632 bins).
GRIDS = {
    "graybox": DEFAULT_CONFIG,
    "config5_s2": scaled_config(bench_scale.CONFIG, 2),
    "config5_s4": scaled_config(bench_scale.CONFIG, 4),
    "wide_52x52x8": RenderConfig(view_width=2048, view_height=2048,
                                 view_length=320),
}
# A grid of 24**3 = 13,824 bins over a 96**3 view (bins of 4 pixels).
LARGE_GRID = RenderConfig(view_width=96, view_height=96, view_length=96,
                          bin_size=4)


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


def mask_bytes(config: RenderConfig) -> int:
    """The keys' V-bit masks of listed bins: 4 B a word, a word per 32
    bins, a mask per key."""
    return 4 * shadow_cuda.STARTS * -(-config.hash_volume // 32)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shade_smem_fits_and_grows_with_the_masks_alone(name):
    cfg = GRIDS[name]
    smem = shadow_cuda.shade_smem_bytes(cfg)
    assert smem <= shadow_cuda.MAX_SMEM
    # Everything but the masks is the band's and the chunk's: the same on
    # a grid 5x deeper, whose volume is 5x the bins.
    deeper = RenderConfig(view_width=cfg.view_width,
                          view_height=cfg.view_height,
                          view_length=5 * cfg.view_length,
                          bin_size=cfg.bin_size,
                          bin_capacity=cfg.bin_capacity)
    assert deeper.hash_volume == 5 * cfg.hash_volume
    chunk = shadow_cuda.SHADE_CHUNK
    fixed = shadow_cuda.shade_smem_bytes(cfg, chunk) - mask_bytes(cfg)
    assert shadow_cuda.shade_smem_bytes(deeper, chunk) \
        - mask_bytes(deeper) == fixed
    # ... and a band holds at most trace_cuda.BAND_PIXELS pixels, so the
    # fixed part is the same at every bin size whose band is full.
    n_pix = trace_cuda.band_pixels(cfg)
    assert n_pix <= trace_cuda.BAND_PIXELS
    assert fixed == shadow_cuda.shade_smem_bytes(GRIDS["graybox"], chunk) \
        - mask_bytes(GRIDS["graybox"]) + 29 * (n_pix - 1600)
    # A staged entry takes cap boxes of 32 B, its live count and its bin.
    assert smem == fixed + mask_bytes(cfg) - (chunk - shadow_cuda.shade_chunk(
        cfg)) * (32 * cfg.bin_capacity + 8)


@pytest.mark.parametrize("name,chunk,blocks", [
    ("graybox", 32, 4), ("config5_s2", 28, 4), ("config5_s4", 28, 4),
    ("wide_52x52x8", 32, 3)])
def test_shade_chunk_keeps_four_blocks_where_it_can(name, chunk, blocks):
    cfg = GRIDS[name]
    assert shadow_cuda.shade_chunk(cfg) == chunk

    def per_sm(c):
        return shadow_cuda.SM_SMEM // (shadow_cuda.shade_smem_bytes(cfg, c)
                                       + shadow_cuda.BLOCK_RESERVED_SMEM)
    assert min(per_sm(chunk), shadow_cuda.MARCH_BLOCKS_PER_SM) == blocks
    if chunk < shadow_cuda.SHADE_CHUNK:
        assert per_sm(chunk + 1) < shadow_cuda.MARCH_BLOCKS_PER_SM


def test_shade_smem_limit_is_the_docstrings():
    """At capacity 8 a block of 40-pixel bins fits up to V = 353,568
    bins: 96 x 29 x 127 fits, 80 x 85 x 52 = 353,600 does not."""
    fits = RenderConfig(view_width=96 * 40, view_height=29 * 40,
                        view_length=127 * 40)
    over = RenderConfig(view_width=80 * 40, view_height=85 * 40,
                        view_length=52 * 40)
    assert fits.hash_volume == 353_568 and over.hash_volume == 353_600
    assert shadow_cuda.shade_chunk(fits) == shadow_cuda.SHADE_CHUNK
    assert shadow_cuda.shade_smem_bytes(fits) <= shadow_cuda.MAX_SMEM
    assert shadow_cuda.shade_smem_bytes(over) > shadow_cuda.MAX_SMEM


@pytest.mark.parametrize("bin_size,rows,bands", [(40, 40, 1), (80, 20, 4),
                                                 (160, 10, 16), (4, 4, 1),
                                                 (48, 33, 2)])
def test_shade_bands_cover_each_tile(bin_size, rows, bands):
    """The winner-input mode marches trace.cu's bands: at most 1,600
    pixels each, covering the tile."""
    cfg = RenderConfig(bin_size=bin_size)
    assert trace_cuda.band_rows(cfg) == rows
    assert trace_cuda.bands(cfg) == bands
    assert (bands - 1) * rows < bin_size <= bands * rows
    assert trace_cuda.band_pixels(cfg) <= max(trace_cuda.BAND_PIXELS,
                                              bin_size)


def large_grid_inputs(n_frames=2, seed=4):
    """demo_world(4) on LARGE_GRID, the player moved: the renderer, the
    device scene, the scene, players and the bin tables."""
    cfg = LARGE_GRID
    scene = demo_world(4, cfg)
    ds = DeviceScene.from_scene(scene, cfg, device="cpu")
    r = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device="cpu")
    rng = np.random.default_rng(seed)
    players = torch.from_numpy(
        (scene.pos[0] + rng.integers(-6, 7, (n_frames, 3))).astype(np.int32))
    be, cnt = batched.bin_stage(r, cache, ds, players)
    return r, ds, scene, players, be, cnt


def test_plain_winner_input_matches_gbuffer_chain_on_a_large_grid():
    r, ds, scene, players, be, cnt = large_grid_inputs()
    assert LARGE_GRID.hash_volume > 12_800
    lights = torch.tensor([[50, 70, 10], [-7, 120, 90]], dtype=torch.int32)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    gbuf = batched.trace_stage(r, ds, be, cnt, players)
    dot, *rays = batched.geometry_stage(r, gbuf, lights)
    lit = batched.shadow_stage(r, ds, be, cnt, players, gbuf, *rays)
    want = batched.shade_stage(r, ds, gbuf,
                               shade.factor_from_dot(dot, lit, LARGE_GRID))
    assert bool(lit.any()) and bool((~lit).any())
    assert bool((winners < 0).any()) and bool((winners >= 0).any())
    args = (winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, LARGE_GRID)
    assert torch.equal(shade.point_frames(*args, frames=False), lit)
    got = shade.point_frames(*args)
    assert torch.equal(got, want)
    # Frame 0 against the C++ oracle, entity 0 at the frame's player.
    pos = scene.pos.copy()
    pos[0] = players[0].numpy()
    golden, _ = native.cpp_render_frame(scene.replace_pos(pos),
                                        Light(*lights[0].tolist()),
                                        LARGE_GRID)
    np.testing.assert_array_equal(got[0].numpy(), golden)


def graybox_orbit(device, orbit, frames, cfg=DEFAULT_CONFIG):
    """Graybox on ``cfg`` and ``frames`` states of one of the bench's three
    orbits: the kernel's arguments, from the trace kernel's winners."""
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


def kernel_equals_plain(args):
    for frames in (True, False):
        n = shadow_cuda.shade_launches
        got = shadow_cuda.shade_point(*args, frames=frames)
        torch.cuda.synchronize()
        assert shadow_cuda.shade_launches == n + 1
        assert torch.equal(got, shade.point_frames(*args, frames=frames))


@pytest.mark.cuda
@pytest.mark.parametrize("orbit", ["center", "edge_x", "edge_z"])
def test_cuda_shade_point_matches_plain_on_graybox_orbits(cuda, orbit):
    kernel_equals_plain(graybox_orbit(cuda, orbit, 16))


@pytest.mark.cuda
def test_cuda_shade_point_bands_that_split_a_tile_unevenly(cuda,
                                                           monkeypatch):
    """Graybox at bins of 48 pixels: 1,600-pixel bands of 33 rows, so each
    tile is a band of 33 rows and one of 15 (and the last bin row is cut
    by the view); then with chunks of 5 entries, so that the keys' lists
    stream over many chunks and rounds are cut."""
    cfg = RenderConfig(bin_size=48)
    assert (trace_cuda.bands(cfg), trace_cuda.band_rows(cfg)) == (2, 33)
    kernel_equals_plain(graybox_orbit(cuda, "center", 4, cfg))
    monkeypatch.setattr(shadow_cuda, "shade_chunk", lambda config: 5)
    kernel_equals_plain(graybox_orbit(cuda, "edge_x", 2))


@pytest.mark.cuda
def test_cuda_shade_point_renders_a_21632_bin_grid(cuda):
    """One frame of the config-5 scene generator on a 2048**2 view at bin
    40 (52 x 52 x 8 bins): shade_point no longer raises, and equals its
    plain version."""
    cfg = GRIDS["wide_52x52x8"]
    assert cfg.hash_volume == 21_632
    scene = bench_scale.config5_scene(config=cfg)
    r = DeferredRenderer(cfg).configure_for(scene)
    ds = DeviceScene.from_scene(scene, cfg, device=cuda)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device=cuda)
    players = torch.tensor(scene.pos[:1], device=cuda)
    lights = torch.tensor([[1024, 400, 160]], dtype=torch.int32, device=cuda)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    kernel_equals_plain((winners, ds.pos, ds.ext, ds.sprite_id,
                         ds.atlas_color, ds.atlas_depth, ds.atlas_normal,
                         ds.palette, be, cnt, players, lights, cfg))


@pytest.mark.cuda
def test_cuda_shade_march_occupancy(cuda):
    for name, want in (("graybox", 4), ("config5_s2", 4), ("config5_s4", 4),
                       ("wide_52x52x8", 3)):
        cfg = GRIDS[name]
        for counting in (False, True):
            smem, blocks, regs, _ = shadow_cuda.shade_occupancy(cfg,
                                                                counting)
            assert smem == shadow_cuda.shade_smem_bytes(cfg)
            assert blocks == want and regs > 0, (name, counting)


def test_shade_phase_marks_match_the_phases():
    """``shade_phases`` names each of the point march's phase marks: the
    march marks phases 0 .. 5 in order and ends the last, and
    ``kShadePhases`` is the count of names."""
    import re
    from pixel_art_raytracer_tpu_torch import shade_phases
    from pixel_art_raytracer_tpu_torch.runtime import kernels
    source = (kernels.CSRC / "common.cuh").read_text()
    body = source[source.index(" march_band(\n"):]
    body = body[:body.index("\n}\n")]
    n = len(shade_phases.PHASES)
    assert [int(a) for a in re.findall(r"phases\.mark\((\d+)\)", body)] \
        == list(range(n - 1))
    assert body.count("phases.end();") == 1
    assert f"constexpr int kShadePhases = {n};" in source
