"""Port primary visibility (``trace_winner``, ``materialize_gbuffer`` and the
trace kernel's wrapper) against the JAX package and the C++ oracle.

Winners, best depths and G-buffers must be bit-identical, including ties
(first candidate wins), the early exit (quirk Q5) and the background
(quirk Q6)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.assets import (SpriteAtlas, concat_atlases,
                                            make_tile_floor)
from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.ops import trace as jtrace
from pixel_art_raytracer_tpu.runtime import native
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu_torch.models.deferred import DeviceScene
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "tie", "early_exit"])
def test_cuda_kernel_matches_plain(cuda, case):
    scene, cfg = {"dense": (dense_scene(seed=7, n=90), SMALL),
                  "tie": (tie_scene(), SMALL),
                  "early_exit": (early_exit_scene(), DEEP)}[case]
    best, win, gb = port_trace(scene, cfg, device=cuda)
    want_best, want_win, want_gb = port_trace(scene, cfg)
    assert torch.equal(win.cpu(), want_win)
    assert torch.equal(best.cpu(), want_best)
    for g, w in zip(gb, want_gb):
        assert torch.equal(g.cpu(), w)
