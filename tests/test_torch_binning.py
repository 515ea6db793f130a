"""Port binning (full rebuild and the static cache merge) against the JAX
package and the C++ oracle.  Tables must be bit-identical, including bins
that overflow the capacity of 8 and wrap (quirk Q3).

The binning kernel (``csrc/binning.cu``): on the CPU, its wrapper's sizing
and refusals and the plain route of ``binning.bin_tables``; on the card
(skipped without one), its tables against the plain version and the
oracle on every scene below, the static cache built on the card, and a
session frame that bins on the kernel alone.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu.runtime import native
from pixel_art_raytracer_tpu.scene import SceneBuilder, demo_world
from pixel_art_raytracer_tpu_torch import config as pconfig
from pixel_art_raytracer_tpu_torch import scene as pscene
from pixel_art_raytracer_tpu_torch.bench_scale import config5_scene
from pixel_art_raytracer_tpu_torch.models.supersample import (scale_scene,
                                                              scaled_config)
from pixel_art_raytracer_tpu_torch.ops import binning, binning_cuda
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import native as pnative
from pixel_art_raytracer_tpu_torch.runtime.session import Session

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene(config=SMALL):
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def overflow_scene(seed=0, config=SMALL):
    """The player plus 13 boxes piled into one bin and a seeded random
    scatter: the pile's bin holds more than 8 entries and wraps."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for _ in range(13):
        b.insert((int(rng.integers(42, 50)), 0, int(rng.integers(2, 10))),
                 (int(rng.integers(4, 12)), int(rng.integers(4, 12)),
                  int(rng.integers(4, 12))))
    for _ in range(30):
        b.insert(tuple(int(v) for v in rng.integers(-10, 80, 3)),
                 (int(rng.integers(1, 21)), int(rng.integers(1, 20)),
                  int(rng.integers(1, 20))))
    return b.build()


SCENES = {
    "small": (small_scene, SMALL),
    "demo": (lambda c: demo_world(6, c), SMALL),
    "overflow": (lambda c: overflow_scene(config=c), SMALL),
}


def spans_of(scene, config):
    return binning.entity_span_bound(scene.ext.max(axis=0), config)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bins_matches_jax_and_cpp(name):
    make, cfg = SCENES[name]
    scene = make(cfg)
    spans = spans_of(scene, cfg)
    assert spans == jbinning.entity_span_bound(scene.ext.max(axis=0), cfg)
    be, cnt = binning.build_bins(torch.from_numpy(scene.pos),
                                 torch.from_numpy(scene.ext), cfg, spans)
    jbe, jcnt = jbinning.build_bins(jnp.asarray(scene.pos),
                                    jnp.asarray(scene.ext), cfg, spans)
    np.testing.assert_array_equal(be.numpy(), np.asarray(jbe))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    cbe, ccnt = native.cpp_build_bins(scene, cfg)
    np.testing.assert_array_equal(be.numpy(), cbe)
    np.testing.assert_array_equal(cnt.numpy(), ccnt)


def test_overflow_scene_wraps():
    scene = overflow_scene()
    totals = jbinning.bin_totals_numpy(scene.pos, scene.ext, SMALL)
    assert totals.max() > SMALL.bin_capacity


PLAYERS = [(30, 20, 20), (44, 0, 4), (-15, 5, 60), (70, 40, -10),
           (500, 0, 0)]


@pytest.mark.parametrize("player", PLAYERS)
def test_static_merge_matches_jax_merge_and_full_rebuild(player):
    scene = overflow_scene()
    spans = spans_of(scene, SMALL)
    cache = StaticBins(scene.pos, scene.ext, 1, SMALL, spans, device="cpu")
    jcache = JStaticBins(scene.pos, scene.ext, 1, SMALL, spans)
    np.testing.assert_array_equal(cache.static_total.numpy(),
                                  np.asarray(jcache.static_total))
    np.testing.assert_array_equal(cache.static_ids.numpy(),
                                  np.asarray(jcache.static_ids))

    dyn = np.asarray(player, np.int32)[None, None]           # (F=1, D=1, 3)
    be, cnt = cache.merge(torch.from_numpy(dyn),
                          torch.from_numpy(scene.ext[None, :1]))
    jbe, jcnt = jcache.merge(jnp.asarray(dyn[0]), jnp.asarray(scene.ext[:1]))
    np.testing.assert_array_equal(be[0].numpy(), np.asarray(jbe))
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray(jcnt))

    pos = scene.pos.copy()
    pos[0] = player
    fbe, fcnt = binning.build_bins(torch.from_numpy(pos),
                                   torch.from_numpy(scene.ext), SMALL, spans)
    assert torch.equal(be[0], fbe) and torch.equal(cnt[0], fcnt)


def test_merge_batches_frames_and_takes_jax_cache():
    scene = overflow_scene(seed=4)
    spans = spans_of(scene, SMALL)
    jcache = JStaticBins(scene.pos, scene.ext, 1, SMALL, spans)
    cache = StaticBins.from_numpy(np.asarray(jcache.static_total),
                                  np.asarray(jcache.static_ids), 1, SMALL,
                                  spans, device="cpu")
    players = np.asarray(PLAYERS, np.int32)
    F = len(players)
    be, cnt = cache.merge(torch.from_numpy(players[:, None]),
                          torch.from_numpy(scene.ext[:1]).expand(F, 1, 3))
    assert be.shape == (F, SMALL.hash_volume, SMALL.bin_capacity)
    for f in range(F):
        pos = scene.pos.copy()
        pos[0] = players[f]
        fbe, fcnt = binning.build_bins(torch.from_numpy(pos),
                                       torch.from_numpy(scene.ext), SMALL,
                                       spans)
        assert torch.equal(be[f], fbe) and torch.equal(cnt[f], fcnt), f


def test_cache_rejects_tables_of_another_grid():
    with pytest.raises(ValueError):
        StaticBins.from_numpy(np.zeros(5, np.int32),
                              np.zeros((5, 9), np.int32), 1, SMALL,
                              (2, 3, 2), device="cpu")


@pytest.mark.cuda
def test_cuda_bins_match_cpu(cuda):
    scene = overflow_scene()
    spans = spans_of(scene, SMALL)
    players = torch.tensor(PLAYERS, dtype=torch.int32)
    ext0 = torch.from_numpy(scene.ext[:1]).expand(len(PLAYERS), 1, 3)
    cpu = StaticBins(scene.pos, scene.ext, 1, SMALL, spans, device="cpu")
    gpu = StaticBins(scene.pos, scene.ext, 1, SMALL, spans, device=cuda)
    # The cache's tables: the kernel's left-aligned layout at window
    # capacity + 1.
    assert torch.equal(gpu.static_total.cpu(), cpu.static_total)
    assert torch.equal(gpu.static_ids.cpu(), cpu.static_ids)
    want = cpu.merge(players[:, None], ext0)
    got = gpu.merge(players[:, None].to(cuda), ext0.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- the binning kernel (csrc/binning.cu) ------------------------------------

GRAYBOX = pconfig.RenderConfig()
CONFIG5_S2 = scaled_config(pconfig.RenderConfig(1024, 1024, 320), 2)
WIDE = pconfig.RenderConfig(view_width=2048, view_height=2048,
                            view_length=320)
# Every grid the repo bins: each fits the count pass's shared memory.
GRIDS = {
    "graybox": GRAYBOX,
    "small": SMALL,
    "config1": pconfig.RenderConfig(view_width=64, view_height=64,
                                    view_length=64),
    "config2": pconfig.RenderConfig(view_width=256, view_height=256,
                                    view_length=320),
    "config5_s2": CONFIG5_S2,
    "config5_s4": scaled_config(pconfig.RenderConfig(1024, 1024, 320), 4),
    "fine": pconfig.RenderConfig(view_width=80, view_height=80,
                                 view_length=160, bin_size=10),
    "large_grid": pconfig.RenderConfig(view_width=96, view_height=96,
                                       view_length=96, bin_size=4),
    "wide_52x52x8": WIDE,
}
# Grids past one tile of the count pass, none of which the port's configs
# use: 4096**2 at bin 40 (103 x 103 x 8) and 40**3 bins of 4 pixels.
WIDE_4096 = pconfig.RenderConfig(view_width=4096, view_height=4096,
                                 view_length=320)
TILED = pconfig.RenderConfig(view_width=160, view_height=160,
                             view_length=160, bin_size=4)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_kernel_sizing_fits_every_grid_the_repo_bins(name):
    cfg = GRIDS[name]
    V = cfg.hash_volume
    tiles = binning_cuda.tiles(cfg)
    assert (tiles - 1) * binning_cuda.TILE_BINS < V <= (
        tiles * binning_cuda.TILE_BINS)
    assert binning_cuda.smem_bytes(cfg) == 8 * min(
        V, binning_cuda.TILE_BINS) <= 64 * 1024
    assert binning_cuda.scratch_shape(cfg, 162_308, 64) == (2, 64, 159, V)
    assert binning_cuda.scratch_shape(cfg, 0, 1) == (2, 1, 1, V)
    assert binning_cuda.scratch_shape(cfg, 1024, 1) == (2, 1, 1, V)
    assert binning_cuda.scratch_shape(cfg, 1025, 1) == (2, 1, 2, V)


def strip(width):
    """A grid of width x 128 x 1 bins."""
    return pconfig.RenderConfig(view_width=width, view_height=128,
                                view_length=1, bin_size=1)


@pytest.mark.parametrize("cfg,bins,tiles", [
    (strip(64), 8192, 1), (strip(65), 8320, 2), (strip(128), 16384, 2),
    (strip(129), 16512, 3), (strip(228), 29184, 4), (WIDE_4096, 84872, 11),
    (TILED, 64000, 8)],
    ids=["64", "65", "128", "129", "228", "103x103x8", "40x40x40"])
def test_kernel_tiles_a_grid_past_one_tile(cfg, bins, tiles):
    """The count pass takes any grid in tiles of TILE_BINS bins: one
    block's shared memory stays at 64 KB (a histogram of the whole grid
    would pass the 227 KB a block may use from 29,057 bins)."""
    assert cfg.hash_volume == bins
    assert binning_cuda.tiles(cfg) == tiles
    assert binning_cuda.smem_bytes(cfg) == 8 * min(bins, 8192)
    assert binning_cuda.scratch_shape(cfg, 5000, 2) == (2, 2, 5, bins)


def wrapper_args(**change):
    args = dict(pos=torch.zeros((5, 3), dtype=torch.int32),
                ext=torch.ones((5, 3), dtype=torch.int32),
                players=torch.zeros((2, 3), dtype=torch.int32),
                config=SMALL, spans=(2, 3, 2), window=8, ring=True)
    args.update(change)
    return args


REFUSED = {
    "pos dtype": (dict(pos=torch.zeros((5, 3), dtype=torch.int64)),
                  "pos: dtype torch.int64"),
    "ext shape": (dict(ext=torch.ones((4, 3), dtype=torch.int32)),
                  r"ext: shape \(4, 3\)"),
    "players shape": (dict(players=torch.zeros((2, 2), dtype=torch.int32)),
                      r"players: shape \(2, 2\)"),
    "players device": (dict(players=torch.zeros((2, 3), dtype=torch.int32,
                                                device="meta")),
                       "players: on meta"),
    "pos strides": (dict(pos=torch.zeros((3, 5), dtype=torch.int32).t()),
                    "pos: not contiguous"),
    "window": (dict(window=0), "window 0"),
    "ring window": (dict(window=9), "power of two, not window 9"),
    "cpu": ({}, "no kernel for device cpu"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_kernel_wrapper_refuses_what_it_does_not_take(case):
    change, message = REFUSED[case]
    before = binning_cuda.launches
    with pytest.raises(ValueError, match=message):
        binning_cuda.bin_tables(**wrapper_args(**change))
    assert binning_cuda.launches == before


def tables_from_pairs(pos, ext, players, config, spans, window, ring,
                      id_offset):
    """The tables of ``binning.plain_tables`` written out bin by bin from
    :func:`binning.ranked_pairs`' pairs."""
    V = config.hash_volume
    frames = [pos.numpy()] if players is None else [
        np.concatenate([np.asarray(p, np.int32)[None], pos.numpy()[1:]])
        for p in players]
    ids = np.full((len(frames), V, window), -1, np.int32)
    counts = np.zeros((len(frames), V), np.int32)
    for f, p in enumerate(frames):
        sorted_bin, pair_ent, rank, totals = binning.ranked_pairs(
            torch.from_numpy(p), ext, config, spans)
        for v in range(V):
            here = sorted_bin == v
            ents, ranks = pair_ent[here].tolist(), rank[here].tolist()
            total = int(totals[v])
            assert ranks == list(range(total))
            first = max(0, total - window)
            for r in range(first, total):
                slot = r & (window - 1) if ring else r - first
                ids[f, v, slot] = ents[r] + id_offset
            counts[f, v] = total & (window - 1) if ring else total
    return ids, counts


@pytest.mark.parametrize("extra,frames", [(0, 0), (1, 0), (0, 3), (2, 3)])
def test_cpu_route_returns_ranked_pairs_tables(extra, frames, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route launched the kernel's wrapper")

    monkeypatch.setattr(binning_cuda, "bin_tables", refuse)
    scene = overflow_scene()
    spans = spans_of(scene, SMALL)
    pos, ext = torch.from_numpy(scene.pos), torch.from_numpy(scene.ext)
    window = SMALL.bin_capacity + extra
    ring = extra == 0
    players = PLAYERS[:frames] or None
    pl = None if players is None else torch.tensor(players, dtype=torch.int32)
    ids, counts = binning.bin_tables(pos, ext, pl, SMALL, spans, window,
                                     ring, extra)
    want_ids, want_counts = tables_from_pairs(pos, ext, players, SMALL, spans,
                                              window, ring, extra)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    if extra == 0 and players is None:
        be, cnt = binning.build_bins(pos, ext, SMALL, spans)
        assert torch.equal(be, ids[0]) and torch.equal(cnt, counts[0])


def culled_scene(config=SMALL):
    """The player, boxes past each side of the cull (alternative.cpp:
    212-219) and boxes just inside it."""
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for p in [(-25, 0, 0), (80, 0, 0), (10, -90, 30), (10, 130, 0),
              (10, 0, -70), (10, 0, 130), (-20, 0, 0), (79, 0, 0),
              (10, 0, 120), (10, 0, -60), (10, -40, 0)]:
        b.insert(p, (20, 20, 20))
    return b.build()


def over_span_scene():
    """Graybox's grid with a 60**3 box among 20**3 ones: its covered range
    is wider than DeferredRenderer's default spans (2, 3, 2) on every
    axis, so both versions drop the same bins (the oracle does not)."""
    b = pscene.SceneBuilder(config=GRAYBOX)
    b.insert((30, 20, 20), (20, 20, 20))
    b.insert((30, 5, 10), (20, 20, 20))
    for i in range(20):
        b.insert((i * 4 - 8, i % 3, (i * 7) % 70), (10, 12, 8))
    scene = b.build()
    ext = scene.ext.copy()
    ext[1] = (60, 60, 60)
    return types.SimpleNamespace(pos=scene.pos, ext=ext)


def spread_scene(config, n, seed):
    """The player and ``n - 1`` seeded boxes of 1-10 pixels a side over
    the whole view, so every tile of the grid holds some."""
    rng = np.random.default_rng(seed)
    b = pscene.SceneBuilder(config=config)
    b.insert((30, 20, 20), (8, 8, 8))
    high = [config.view_width, config.view_height, config.view_length]
    for _ in range(n - 1):
        b.insert(tuple(int(v) for v in rng.integers(-8, high)),
                 tuple(int(v) for v in rng.integers(1, 11, 3)))
    return b.build()


# name -> () -> (pos, ext, config, spans or None for the scene's own
# bound, players or None)
KERNEL_CASES = {
    "small": lambda: (small_scene(), SMALL, None, None),
    "demo": lambda: (demo_world(6, SMALL), SMALL, None, None),
    "overflow": lambda: (overflow_scene(), SMALL, None, None),
    "graybox": lambda: (pscene.graybox_world(), GRAYBOX, None, None),
    "config5": lambda: (scale_scene(config5_scene(), 2), CONFIG5_S2, None,
                        None),
    "wide_52x52x8": lambda: (config5_scene(config=WIDE), WIDE, None, None),
    "culled": lambda: (culled_scene(), SMALL, None, None),
    "over_span": lambda: (over_span_scene(), GRAYBOX, (2, 3, 2), None),
    "frames3": lambda: (overflow_scene(seed=2), SMALL, None,
                        [(30, 20, 20), (44, 0, 4), (-15, 5, 60)]),
    "tiled_103x103x8": lambda: (config5_scene(config=WIDE_4096), WIDE_4096,
                                None, None),
    "tiled_40x40x40": lambda: (spread_scene(TILED, 6000, 5), TILED, None,
                               [(30, 20, 20), (150, 3, 80)]),
}


def oracle_tables(scene, players, config):
    """``native.cpp_build_bins`` of each frame (entity 0 at its player)."""
    frames = []
    for player in players or [None]:
        pos = np.array(scene.pos, np.int32)
        if player is not None:
            pos[0] = player
        frames.append(pnative.cpp_build_bins(types.SimpleNamespace(
            n_entities=len(pos), pos=pos, ext=scene.ext), config))
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_cuda_kernel_tables_match_plain_and_oracle(cuda, name):
    scene, cfg, spans, players = KERNEL_CASES[name]()
    own = spans_of(scene, cfg)
    spans = spans or own
    pos = torch.from_numpy(np.ascontiguousarray(scene.pos, np.int32))
    ext = torch.from_numpy(np.ascontiguousarray(scene.ext, np.int32))
    pl = None if players is None else torch.tensor(players, dtype=torch.int32)
    args = [(pos, ext, pl), tuple(None if t is None else t.to(cuda)
                                  for t in (pos, ext, pl))]
    if name == "culled":
        _, valid = binning.covered_bins(pos, ext, cfg, spans)
        assert (~valid.any(-1)).sum() >= 6
    cap = cfg.bin_capacity
    for window, ring in ((cap, True), (cap + 1, False)):
        before = binning_cuda.launches
        got = binning.bin_tables(*args[1], cfg, spans, window, ring,
                                 window - cap)
        assert binning_cuda.launches == before + 2
        want = binning.plain_tables(*args[0], cfg, spans, window, ring,
                                    window - cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (name, window)
        if window == cap:
            tables = [t.cpu().numpy() for t in got]
    if name == "overflow":
        assert int(want[1].max()) > cap   # the wrap
    if name == "tiled_40x40x40":   # every tile of the count pass binned some
        tile = binning_cuda.TILE_BINS
        assert all(tables[1][:, t:t + tile].any()
                   for t in range(0, cfg.hash_volume, tile))
    # The oracle does not clip to spans: equal wherever spans hold the
    # scene's own bound, and it differs where the kernel clipped.
    if spans != own:
        clipped = tables
        tables = [t.cpu().numpy() for t in binning.bin_tables(
            *args[1], cfg, own, cap, True)]
        assert not np.array_equal(clipped[0], tables[0])
    for f, (obe, ocnt) in enumerate(oracle_tables(scene, players, cfg)):
        np.testing.assert_array_equal(tables[0][f], obe)
        np.testing.assert_array_equal(tables[1][f], ocnt)


def port_small_scene():
    b = pscene.SceneBuilder(config=pconfig.RenderConfig(
        view_width=80, view_height=80, view_length=80))
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


@pytest.mark.cuda
def test_cuda_session_frame_bins_on_the_kernel_alone(cuda):
    cfg = pconfig.RenderConfig(view_width=80, view_height=80,
                               view_length=80)
    scene = port_small_scene()
    light = pscene.Light(60, 60, 20)
    card = Session(scene, light, cfg, device=cuda)
    host = Session(scene, light, cfg, device="cpu")
    keys, mouse = ["left", "a"], (30, 40)
    card.feed(keys, mouse=mouse)
    host.feed(keys, mouse=mouse)
    torch.cuda.synchronize()
    before = binning_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = card.feed(keys, mouse=mouse)
        torch.cuda.synchronize()
    assert binning_cuda.launches == before + 2
    names = [ev.name for ev in prof.events()]
    assert "sync.bincount" not in names
    assert any("bin_count_kernel" in n for n in names)
    assert any("bin_place_kernel" in n for n in names)
    for banned in ("cummax", "scan_innermost", "RadixSort", "Histogram"):
        assert not any(banned in n for n in names), banned
    want = host.feed(keys, mouse=mouse)
    np.testing.assert_array_equal(got.image, want.image)
    assert (got.mouse_pixel_y, got.mouse_pixel_z) == (
        want.mouse_pixel_y, want.mouse_pixel_z)
