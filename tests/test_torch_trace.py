"""Port primary visibility (``trace_winner``, ``materialize_gbuffer`` and the
trace kernel's wrapper) against the JAX package and the C++ oracle.

Winners, best depths and G-buffers must be bit-identical, including ties
(first candidate wins), the early exit (quirk Q5) and the background
(quirk Q6).  A plain model of the kernels' walk (csrc/common.cuh
walk_column: each column's live slots drawn in walk order over their
clipped footprints, the adjacent-hit counter kept lazily) is held to the
same results."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pixel_art_raytracer_tpu.assets import (SpriteAtlas, concat_atlases,
                                            make_tile_floor)
from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.ops import trace as jtrace
from pixel_art_raytracer_tpu.runtime import native
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu_torch.models.deferred import DeviceScene
from pixel_art_raytracer_tpu_torch.models.supersample import (scale_scene,
                                                              scaled_config)
from pixel_art_raytracer_tpu_torch.ops import binning, trace, trace_cuda

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
# Four bins deep, so a walk can stop before its last bin.
DEEP = RenderConfig(view_width=80, view_height=80, view_length=160)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tie_scene(config=SMALL):
    """A small scene with entities 3 and 4 identical: every pixel they
    cover is a depth tie, which the earlier candidate wins."""
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    b.insert((0, 0, 0), (16, 16, 16))
    b.insert((24, 0, 48), (16, 16, 16))
    b.insert((52, 0, 8), (12, 10, 14))
    b.insert((52, 0, 8), (12, 10, 14))
    return b.build()


# A ragged view: the last bin column and row are partial.
RAGGED = RenderConfig(view_width=100, view_height=90, view_length=80)


def dense_scene(seed=0, n=60, config=SMALL):
    """Seeded random boxes, dense enough that bins overflow and wrap."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for _ in range(n):
        b.insert(tuple(int(v) for v in rng.integers(-5, 75, 3)),
                 (int(rng.integers(2, 21)), int(rng.integers(2, 20)),
                  int(rng.integers(2, 20))))
    return b.build()


def early_exit_scene(config=DEEP):
    """Boxes 1, 2, 3 in bin z = 0, 1, 2 of the same pixels, with sprite
    depth offsets (+200, +100, +0) that make each one nearer than the last:
    the walk stops after box 2 (quirk Q5), so box 3 never wins where it
    would without the early exit."""
    tile = make_tile_floor()

    def offset(d):
        return SpriteAtlas(color=tile.color, depth=tile.depth + d,
                           normal=tile.normal)

    b = SceneBuilder(atlas=concat_atlases(tile, offset(200), offset(100)),
                     config=config)
    b.insert((60, 0, 0), (10, 10, 10))
    b.insert((10, 40, 20), (20, 20, 15), sprite_id=1)
    b.insert((10, 15, 45), (20, 20, 15), sprite_id=2)
    b.insert((10, -25, 85), (20, 20, 15), sprite_id=0)
    return b.build()


def empty_reset_scene(config=DEEP):
    """Boxes 1, 2, 3 in bins z = 0, 2, 3 of the same pixels (bin 1 empty),
    each nearer than the last (sprite depth offsets +400, +200, +0).  The
    empty bin resets the adjacent-hit counter, so the walk stops after bin
    3, not bin 2, and box 3 wins under the early exit too."""
    tile = make_tile_floor()

    def offset(d):
        return SpriteAtlas(color=tile.color, depth=tile.depth + d,
                           normal=tile.normal)

    b = SceneBuilder(atlas=concat_atlases(tile, offset(400), offset(200)),
                     config=config)
    b.insert((60, 0, 0), (10, 10, 10))
    b.insert((10, 40, 20), (20, 20, 15), sprite_id=1)
    b.insert((10, -25, 85), (20, 20, 15), sprite_id=2)
    b.insert((10, -65, 125), (20, 20, 15), sprite_id=0)
    return b.build()


def tables(scene, config):
    spans = binning.entity_span_bound(scene.ext.max(axis=0), config)
    be, cnt = binning.build_bins(torch.from_numpy(scene.pos),
                                 torch.from_numpy(scene.ext), config, spans)
    return be[None], cnt[None]


def port_trace(scene, config, device="cpu"):
    ds = DeviceScene.from_scene(scene, config, device=device)
    be, cnt = (t.to(device) for t in tables(scene, config))
    best, win = trace_cuda.trace_winners(
        ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, ds.pos[:1],
        config, with_best=True)
    gb = trace.materialize_gbuffer(win, ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_color, ds.atlas_depth,
                                   ds.atlas_normal, ds.palette, ds.pos[:1],
                                   config)
    return best[0], win[0], gb


def jax_trace(scene, config):
    spans = jbinning.entity_span_bound(scene.ext.max(axis=0), config)
    pos, ext = jnp.asarray(scene.pos), jnp.asarray(scene.ext)
    be, cnt = jbinning.build_bins(pos, ext, config, spans)
    sid = jnp.asarray(scene.sprite_id)
    a = scene.atlas
    best, win = jtrace.trace_winner(pos, ext, sid, jnp.asarray(a.depth), be,
                                    cnt, config)
    gb = jtrace.materialize_gbuffer(
        win, pos, ext, sid, jnp.asarray(a.color), jnp.asarray(a.depth),
        jnp.asarray(a.normal), jnp.asarray(config.palette_array), config)
    return np.asarray(best), np.asarray(win), gb


def draw_model(scene, be, cnt, config, work=None, band_rows=None):
    """``(best, winner)`` (H, W) of one frame, by the kernels' walk.

    Each bin column's tile is walked in row bands of ``band_rows`` rows
    (default: the kernels' ``trace_cuda.band_rows``), each band on its own
    as one block of the kernels does.  For each band, the live slots
    (k < min(count, cap)) in walk order whose footprint in the band is not
    empty are drawn one at a time over that footprint: a pixel that the
    reference has stopped walking (adjacent-hit count >= 2, last improving
    bin before this one) is skipped; else the depth key replaces the best
    where strictly greater, and on the first improvement in a bin the count
    becomes (0 if an empty bin lies after the last improving bin, else the
    count) + 1.  Where ``work`` is given, ``work["candidate_hits"]`` counts
    the pixels drawn and not skipped."""
    cfg = config
    H, W, bs = cfg.view_height, cfg.view_width, cfg.bin_size
    hl, cap = cfg.hash_length, cfg.bin_capacity
    sh, sw = cfg.sprite_height, cfg.sprite_width
    rows = trace_cuda.band_rows(cfg) if band_rows is None else band_rows
    pos, ext = scene.pos.astype(np.int64), scene.ext.astype(np.int64)
    depth_flat = scene.atlas.depth.reshape(-1).astype(np.int64)
    best = np.full((H, W), np.iinfo(np.int32).min, np.int64)
    winner = np.full((H, W), -1, np.int64)
    count = np.zeros((H, W), np.int64)
    last = np.full((H, W), -1, np.int64)
    drawn = 0
    bands = [(bx, by, r0) for bx in range(cfg.hash_width)
             for by in range(cfg.hash_height) for r0 in range(0, bs, rows)]
    for bx, by, r0 in bands:
        col = (bx * cfg.hash_height + by) * hl
        i0, j0 = bx * bs, by * bs + r0
        i1, j1 = min(i0 + bs, W), min(j0 + rows, by * bs + bs, H)
        for bz in range(hl):
            c = int(cnt[col + bz])
            last_empty = max((z for z in range(bz) if cnt[col + z] == 0),
                             default=-1)
            for k in range(min(c, cap)):
                e = int(be[col + bz, k])
                px, py, pz = pos[e]
                ex, ey, ez = ext[e]
                top = py + ey + pz + ez
                xa, xb = max(px, i0), min(px + ex, i1)
                ja, jb = max(H - top, j0), min(H - py - pz, j1)
                if xa >= xb or ja >= jb:
                    continue
                jj, ii = np.mgrid[ja:jb, xa:xb]
                win = np.s_[ja:jb, xa:xb]
                row = top - (H - jj)
                tex = ((scene.sprite_id[e] * sh + row.clip(0, sh - 1))
                       * sw + (ii - px).clip(0, sw - 1))
                key = py - pz + np.minimum(0, ey - row) - depth_flat[tex]
                live = ~(cfg.early_exit & (count[win] >= 2)
                         & (last[win] < bz))
                drawn += int(live.sum())
                better = live & (key > best[win])
                first = better & (last[win] != bz)
                best[win] = np.where(better, key, best[win])
                winner[win] = np.where(better, e, winner[win])
                count[win] = np.where(
                    first, np.where(last_empty > last[win], 0,
                                    count[win]) + 1, count[win])
                last[win] = np.where(first, bz, last[win])
    if work is not None:
        work["candidate_hits"] = drawn
    return best.astype(np.int32), winner.astype(np.int32)


def assert_gbuffer_equal(gb, want):
    """``gb`` a port G-buffer (leading frame axis of 1), ``want`` any
    G-buffer of numpy-convertible (H, W, ...) fields."""
    for field in ("normal", "color", "y", "z", "entity_index"):
        got = getattr(gb, field)[0].numpy()
        ref = np.asarray(getattr(want, field))
        if field == "normal":
            got, ref = got.view(np.int32), ref.astype(np.float32).view(
                np.int32)
        np.testing.assert_array_equal(got, ref, err_msg=field)


@pytest.mark.parametrize("scene_fn", [tie_scene, dense_scene,
                                      lambda: dense_scene(seed=7, n=90)],
                         ids=["tie", "dense0", "dense7"])
def test_trace_matches_jax_and_cpp(scene_fn):
    scene = scene_fn()
    best, win, gb = port_trace(scene, SMALL)
    jbest, jwin, jgb = jax_trace(scene, SMALL)
    np.testing.assert_array_equal(win.numpy(), jwin)
    np.testing.assert_array_equal(best.numpy(), jbest)
    assert_gbuffer_equal(gb, jgb)
    be, cnt = tables(scene, SMALL)
    assert_gbuffer_equal(gb, native.cpp_trace_pixels(scene, be[0].numpy(),
                                                     cnt[0].numpy(), SMALL))
    # Background pixels: zero y/z/entity, background color (quirk Q6).
    bg = win < 0
    assert bg.any()
    assert (gb.entity_index[0][bg] == 0).all() and (gb.y[0][bg] == 0).all()
    assert (gb.color[0][bg] == torch.tensor(SMALL.background,
                                            dtype=torch.uint8)).all()


def test_tie_keeps_first_candidate():
    _, win, _ = port_trace(tie_scene(), SMALL)
    assert (win == 3).any()
    assert not (win == 4).any()


@pytest.mark.parametrize("early_exit", [True, False])
def test_early_exit_matches_jax_and_cpp(early_exit):
    cfg = dataclasses.replace(DEEP, early_exit=early_exit)
    scene = early_exit_scene(cfg)
    best, win, gb = port_trace(scene, cfg)
    jbest, jwin, _ = jax_trace(scene, cfg)
    np.testing.assert_array_equal(win.numpy(), jwin)
    np.testing.assert_array_equal(best.numpy(), jbest)
    be, cnt = tables(scene, cfg)
    assert_gbuffer_equal(gb, native.cpp_trace_pixels(scene, be[0].numpy(),
                                                     cnt[0].numpy(), cfg))
    # Box 3 wins exactly where the walk does not stop early.
    assert (win == 3).any() != early_exit
    assert (win == 2).any() == early_exit


def test_batched_frames_move_the_player():
    scene = dense_scene(seed=3)
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    players = torch.tensor([[30, 20, 20], [10, 0, 50], [60, 30, 0]],
                           dtype=torch.int32)
    spans = binning.entity_span_bound(scene.ext.max(axis=0), SMALL)
    bes, cnts = [], []
    for p in players:
        pos = ds.pos.clone()
        pos[0] = p
        be, cnt = binning.build_bins(pos, ds.ext, SMALL, spans)
        bes.append(be)
        cnts.append(cnt)
    win = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_depth, torch.stack(bes),
                                   torch.stack(cnts), players, SMALL)
    for f, p in enumerate(players):
        moved = dataclasses.replace(scene, pos=scene.pos.copy())
        moved.pos[0] = p.numpy()
        _, jwin, _ = jax_trace(moved, SMALL)
        np.testing.assert_array_equal(win[f].numpy(), jwin, err_msg=str(f))


def test_wrapper_refuses_other_devices():
    scene = tie_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="meta")
    be, cnt = (t.to("meta") for t in tables(scene, SMALL))
    with pytest.raises(ValueError):
        trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                 ds.atlas_depth, be, cnt, ds.pos[:1], SMALL)


WALK_SCENES = {
    "tie": lambda: (tie_scene(), SMALL),
    "dense0": lambda: (dense_scene(), SMALL),
    "dense7": lambda: (dense_scene(seed=7, n=90), SMALL),
    "early_exit": lambda: (early_exit_scene(), DEEP),
    "early_exit_off": lambda: (
        early_exit_scene(dataclasses.replace(DEEP, early_exit=False)),
        dataclasses.replace(DEEP, early_exit=False)),
    "empty_reset": lambda: (empty_reset_scene(), DEEP),
    "ragged": lambda: (dense_scene(seed=5, n=70, config=RAGGED), RAGGED),
}


def assert_draw_model_matches(scene, cfg, band_rows=None):
    """The walk model (in bands of ``band_rows`` rows, default the
    kernels'), the port's trace_winner and the JAX package's agree bit for
    bit, and the model draws as many pixels as trace_winner counts
    candidate hits."""
    be, cnt = tables(scene, cfg)
    work, model_work = {}, {}
    mbest, mwin = draw_model(scene, be[0].numpy(), cnt[0].numpy(), cfg,
                             model_work, band_rows)
    ds = DeviceScene.from_scene(scene, cfg, device="cpu")
    best, win = trace.trace_winner(ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_depth, be, cnt, ds.pos[:1], cfg,
                                   work=work)
    jbest, jwin, _ = jax_trace(scene, cfg)
    np.testing.assert_array_equal(mwin, win[0].numpy())
    np.testing.assert_array_equal(mbest, best[0].numpy())
    np.testing.assert_array_equal(mwin, jwin)
    np.testing.assert_array_equal(mbest, jbest)
    assert model_work["candidate_hits"] == int(work["candidate_hits"])
    assert int(work["candidate_hits"]) <= int(work["candidate_tests"])
    return mwin


@pytest.mark.parametrize("case", sorted(WALK_SCENES))
def test_draw_model_matches_trace_winner(case):
    scene, cfg = WALK_SCENES[case]()
    win = assert_draw_model_matches(scene, cfg)
    assert (win >= 0).any() and (win < 0).any()


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), early_exit=st.booleans())
def test_draw_model_matches_on_random_deep_scenes(seed, early_exit):
    cfg = dataclasses.replace(DEEP, early_exit=early_exit)
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=cfg)
    b.insert((30, 20, 20), (20, 20, 20))
    for _ in range(40):
        b.insert((int(rng.integers(-5, 75)), int(rng.integers(-60, 60)),
                  int(rng.integers(0, 150))),
                 (int(rng.integers(2, 21)), int(rng.integers(2, 20)),
                  int(rng.integers(2, 20))))
    assert_draw_model_matches(b.build(), cfg)


def scaled_walk_case(case, s):
    """A walk scene and its config, supersampled by s: bins of 40 * s
    pixels, walked in trace_cuda.bands of them."""
    scene, cfg = WALK_SCENES[case]()
    return scale_scene(scene, s), scaled_config(cfg, s)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("case", sorted(WALK_SCENES))
def test_banded_draw_model_matches_trace_winner(case, s):
    """Tiles of 80 and 160 pixels a side, walked in 4 bands of 20 rows and
    16 bands of 10."""
    scene, cfg = scaled_walk_case(case, s)
    assert trace_cuda.bands(cfg) == {2: 4, 4: 16}[s]
    win = assert_draw_model_matches(scene, cfg)
    assert (win >= 0).any() and (win < 0).any()


@settings(max_examples=6, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), early_exit=st.booleans(),
       band_rows=st.sampled_from([None, 1, 7, 33]))
def test_banded_draw_model_matches_on_random_deep_scenes(seed, early_exit,
                                                          band_rows):
    """Random deep scenes at s = 2 (80-pixel bins), in the kernels' bands
    and in bands that leave a short last band."""
    cfg = dataclasses.replace(DEEP, early_exit=early_exit)
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=cfg)
    b.insert((30, 20, 20), (20, 20, 20))
    for _ in range(40):
        b.insert((int(rng.integers(-5, 75)), int(rng.integers(-60, 60)),
                  int(rng.integers(0, 150))),
                 (int(rng.integers(2, 21)), int(rng.integers(2, 20)),
                  int(rng.integers(2, 20))))
    assert_draw_model_matches(scale_scene(b.build(), 2),
                              scaled_config(cfg, 2), band_rows)


@pytest.mark.parametrize("early_exit", [True, False])
def test_empty_bin_resets_the_adjacent_hit_counter(early_exit):
    cfg = dataclasses.replace(DEEP, early_exit=early_exit)
    scene = empty_reset_scene(cfg)
    be, cnt = tables(scene, cfg)
    # The boxes' column: bins 0, 2 and 3 hold one box each, bin 1 none.
    col = cfg.bin_flat_index(0, 0, 0)
    np.testing.assert_array_equal(cnt[0, col:col + 4].numpy(), [1, 0, 1, 1])
    best, win, gb = port_trace(scene, cfg)
    jbest, jwin, _ = jax_trace(scene, cfg)
    np.testing.assert_array_equal(win.numpy(), jwin)
    np.testing.assert_array_equal(best.numpy(), jbest)
    assert_gbuffer_equal(gb, native.cpp_trace_pixels(scene, be[0].numpy(),
                                                     cnt[0].numpy(), cfg))
    # Without the reset the walk would stop after bin 2 under the early
    # exit; with it, box 3 (bin 3) wins either way.
    assert (win == 3).any()
    assert not (win == 2).any()


def test_ragged_view_matches_jax_and_cpp():
    scene = dense_scene(seed=5, n=70, config=RAGGED)
    best, win, gb = port_trace(scene, RAGGED)
    jbest, jwin, jgb = jax_trace(scene, RAGGED)
    np.testing.assert_array_equal(win.numpy(), jwin)
    np.testing.assert_array_equal(best.numpy(), jbest)
    be, cnt = tables(scene, RAGGED)
    assert_gbuffer_equal(gb, native.cpp_trace_pixels(scene, be[0].numpy(),
                                                     cnt[0].numpy(), RAGGED))
    # The edge columns and rows are partial, and hold hits.
    assert RAGGED.view_width % RAGGED.bin_size != 0
    assert (win[:, 80:] >= 0).any() and (win[80:, :] >= 0).any()


def test_shared_memory_layout():
    from pixel_art_raytracer_tpu_torch.config import DEFAULT_CONFIG
    from pixel_art_raytracer_tpu_torch.config import RenderConfig as Config
    # graybox: a draw list of 4 + 16 * 64 ints, an 8-bin column of 65 ints
    # a bin, and three ints for each of the 40 x 40 pixels: one band.
    assert trace_cuda.smem_bytes(DEFAULT_CONFIG) == 4 * (4 + 16 * 64 + 8 * 65
                                                         + 3 * 1600)
    assert trace_cuda.smem_bytes(DEFAULT_CONFIG) <= trace_cuda.MAX_SMEM
    assert trace_cuda.block_threads(DEFAULT_CONFIG) == 320
    assert trace_cuda.bands(DEFAULT_CONFIG) == 1
    # Config 5 (1024 x 1024 x 320) at s = 1, 2, 4: 40-, 80- and 160-pixel
    # tiles in bands of 40, 20 and 10 rows, each 1,600 pixels, so the
    # block keeps graybox's 25,392 B (it would take 25,392, 82,992 and
    # 313,392 B for whole tiles).
    for s, rows in ((1, 40), (2, 20), (4, 10)):
        cfg = scaled_config(Config(1024, 1024, 320), s)
        assert (trace_cuda.band_rows(cfg), trace_cuda.bands(cfg)) == (
            rows, 40 * s // rows)
        assert trace_cuda.smem_bytes(cfg) == 25392
        assert trace_cuda.block_threads(cfg) == 320
    # A short last band: 120-pixel bins in 9 bands of 13 rows and one of 3.
    cfg = scaled_config(Config(1024, 1024, 320), 3)
    assert (trace_cuda.band_rows(cfg), trace_cuda.bands(cfg)) == (13, 10)


# Scenes of the CUDA tests: (scene, config, players (F, 3)).
def cuda_case(case):
    if case == "multi_frame":
        scene = dense_scene(seed=3)
        players = np.array([[30, 20, 20], [10, 0, 50], [60, 30, 0]],
                           np.int32)
        return scene, SMALL, players
    if case.endswith(("_s2", "_s4")):  # a supersampled walk scene
        name, s = case.rsplit("_s", 1)
        scene, cfg = scaled_walk_case(name, int(s))
        return scene, cfg, scene.pos[:1].astype(np.int32)
    scene, cfg = {"dense": lambda: (dense_scene(seed=7, n=90), SMALL),
                  "tie": lambda: (tie_scene(), SMALL),
                  "early_exit": lambda: (early_exit_scene(), DEEP),
                  "empty_reset": lambda: (empty_reset_scene(), DEEP),
                  "ragged": lambda: (dense_scene(seed=5, n=70,
                                                 config=RAGGED), RAGGED),
                  }[case]()
    return scene, cfg, scene.pos[:1].astype(np.int32)


def kernel_inputs(case, device):
    """trace_winners' arguments for a CUDA test case, on ``device``."""
    scene, cfg, players = cuda_case(case)
    ds = DeviceScene.from_scene(scene, cfg, device="cpu")
    spans = binning.entity_span_bound(scene.ext.max(axis=0), cfg)
    tabs = []
    for p in players:
        pos = ds.pos.clone()
        pos[0] = torch.from_numpy(p)
        tabs.append(binning.build_bins(pos, ds.ext, cfg, spans))
    be = torch.stack([b for b, _ in tabs])
    cnt = torch.stack([c for _, c in tabs])
    return tuple(t.to(device) for t in (
        ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt,
        torch.from_numpy(players))) + (cfg,)


# Supersampled walk scenes (SMALL and DEEP at s = 2 and 4): 80- and
# 160-pixel tiles, walked in bands.
BANDED_CASES = ["dense7_s2", "dense7_s4", "early_exit_s4", "ragged_s2"]
CUDA_CASES = ["dense", "tie", "early_exit", "empty_reset", "ragged",
              "multi_frame"] + BANDED_CASES


@pytest.mark.cuda
def test_cuda_shared_memory_matches_layout(cuda):
    from pixel_art_raytracer_tpu_torch.config import DEFAULT_CONFIG
    for cfg in (SMALL, DEEP, RAGGED, DEFAULT_CONFIG, scaled_config(SMALL, 2),
                scaled_config(SMALL, 4), scaled_config(DEFAULT_CONFIG, 4)):
        smem, blocks, regs, _ = trace_cuda.occupancy(cfg)
        assert smem == trace_cuda.smem_bytes(cfg)
        assert blocks >= 1 and 0 < regs <= 255


@pytest.mark.cuda
def test_cuda_banded_blocks_keep_graybox_occupancy(cuda):
    """Graybox and config 5 at s = 2 and 4 launch blocks of 25,392 B, 6 to
    an SM."""
    from pixel_art_raytracer_tpu_torch.config import DEFAULT_CONFIG
    from pixel_art_raytracer_tpu_torch.config import RenderConfig as Config
    for cfg in (DEFAULT_CONFIG, scaled_config(Config(1024, 1024, 320), 2),
                scaled_config(Config(1024, 1024, 320), 4)):
        smem, blocks, _, _ = trace_cuda.occupancy(cfg)
        assert smem == 25392
        assert blocks >= 6


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, case):
    args = kernel_inputs(case, cuda)
    launches = trace_cuda.launches
    best, win = trace_cuda.trace_winners(*args, with_best=True)
    torch.cuda.synchronize()
    assert trace_cuda.launches == launches + 1
    cpu_args = kernel_inputs(case, "cpu")
    want_best, want_win = trace_cuda.trace_winners(*cpu_args, with_best=True)
    assert torch.equal(win.cpu(), want_win)
    assert torch.equal(best.cpu(), want_best)
    scene, cfg, _ = cuda_case(case)
    ds = DeviceScene.from_scene(scene, cfg, device=cuda)
    gb = trace.materialize_gbuffer(win, ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_color, ds.atlas_depth,
                                   ds.atlas_normal, ds.palette, args[6], cfg)
    ds_cpu = DeviceScene.from_scene(scene, cfg, device="cpu")
    want_gb = trace.materialize_gbuffer(
        want_win, ds_cpu.pos, ds_cpu.ext, ds_cpu.sprite_id,
        ds_cpu.atlas_color, ds_cpu.atlas_depth, ds_cpu.atlas_normal,
        ds_cpu.palette, cpu_args[6], cfg)
    for g, w in zip(gb, want_gb):
        assert torch.equal(g.cpu(), w)

