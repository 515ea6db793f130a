"""Port binning (full rebuild and the static cache merge) against the JAX
package and the C++ oracle.  Tables must be bit-identical, including bins
that overflow the capacity of 8 and wrap (quirk Q3)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu.runtime import native
from pixel_art_raytracer_tpu.scene import SceneBuilder, demo_world
from pixel_art_raytracer_tpu_torch.ops import binning
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins

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
    want = cpu.merge(players[:, None], ext0)
    got = gpu.merge(players[:, None].to(cuda), ext0.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
