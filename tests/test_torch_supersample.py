"""The port's supersampled rendering (``models/supersample.py``) against the
JAX package's, run on the CPU as ``tests/test_extensions.py`` runs it, and
against the C++ oracle on the scaled scene.

The tolerance is exact: scaled configs and atlases equal field for field
and value for value, frames equal pixel for pixel."""

import dataclasses

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu import assets as jassets
from pixel_art_raytracer_tpu import config as jconfig
from pixel_art_raytracer_tpu import scene as jscene
from pixel_art_raytracer_tpu.models import supersample as jsupersample
from pixel_art_raytracer_tpu.ops import trace_pallas
from pixel_art_raytracer_tpu_torch import assets, config, scene
from pixel_art_raytracer_tpu_torch.models import supersample
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import DeferredRenderer
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import native

SMALL = config.RenderConfig(view_width=80, view_height=80, view_length=80)
JSMALL = jconfig.RenderConfig(view_width=80, view_height=80, view_length=80)
CONFIG5 = config.RenderConfig(view_width=1024, view_height=1024,
                              view_length=320)
LIGHT = (60, 60, 20)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(builder=scene.SceneBuilder, cfg=SMALL):
    """``tests/test_extensions.small_scene`` with either package's
    builder."""
    b = builder(config=cfg)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def tile_floor():
    return assets.make_tile_floor()


def two_band():
    """``tools/bench_scale.py``'s non-ramp atlas: the tile and a copy whose
    top face is 3 deeper in its right half."""
    tile = assets.make_tile_floor()
    h, w = tile.depth.shape[-2:]
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    depth1 = (np.maximum(0, 19 - r) + np.where(c >= w // 2, 3, 0)).astype(
        np.int32)
    return assets.SpriteAtlas(
        color=np.stack([tile.color[0], tile.color[0]]),
        depth=np.stack([tile.depth[0], depth1]),
        normal=np.stack([tile.normal[0], tile.normal[0]]))


def zero_slope():
    """The tile, a flat sprite of depth 5 (a ramp of slope 0) and one of
    depth 0, with seeded colours."""
    tile = assets.make_tile_floor()
    rng = np.random.default_rng(0)
    shape = tile.color.shape
    flat = [assets.SpriteAtlas(
        color=rng.integers(0, 4, shape).astype(np.int32),
        depth=np.full(shape, d, np.int32), normal=tile.normal)
        for d in (5, 0)]
    return assets.concat_atlases(tile, *flat)


ATLASES = {"tile_floor": tile_floor, "two_band": two_band,
           "zero_slope": zero_slope}


def jax_atlas(a):
    return jassets.SpriteAtlas(color=a.color, depth=a.depth, normal=a.normal)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_scaled_config_matches_jax(s):
    for cfg in (SMALL, config.DEFAULT_CONFIG, CONFIG5):
        jcfg = jconfig.RenderConfig(**dataclasses.asdict(cfg))
        got = dataclasses.asdict(supersample.scaled_config(cfg, s))
        assert got == dataclasses.asdict(jsupersample.scaled_config(jcfg, s))
    # The grid keeps its shape; the tile grows.
    c5 = supersample.scaled_config(CONFIG5, s)
    assert (c5.hash_width, c5.hash_height, c5.hash_length) == (26, 26, 8)
    assert c5.bin_size == 40 * s


@pytest.mark.parametrize("atlas", sorted(ATLASES))
def test_ramp_depth_params_matches_jax(atlas):
    depth = ATLASES[atlas]().depth
    got = supersample.ramp_depth_params(depth)
    want = trace_pallas.ramp_depth_params(depth)
    assert (got is None) == (want is None) == (atlas == "two_band")
    if got is not None:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("atlas", sorted(ATLASES))
def test_scale_atlas_matches_jax(atlas, s):
    a = ATLASES[atlas]()
    got = supersample.scale_atlas(a, s)
    want = jsupersample.scale_atlas(jax_atlas(a), s)
    assert isinstance(got, assets.SpriteAtlas)
    for field in ("color", "depth", "normal"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.depth.shape == (a.n_sprites, 40 * s, 20 * s)
    if atlas == "zero_slope":  # flat sprites keep s * d0
        assert (got.depth[1] == 5 * s).all() and (got.depth[2] == 0).all()


@pytest.mark.parametrize("s", [2, 3])
def test_render_matches_jax(s):
    """The box-filtered frame, bit for bit: at s = 3 the mean divides by 9,
    not a power of two."""
    got = supersample.SupersampledRenderer(SMALL, s).render_numpy(
        small_scene(), scene.Light(*LIGHT), device="cpu")
    want = jsupersample.SupersampledRenderer(JSMALL, s).render_numpy(
        small_scene(jscene.SceneBuilder, JSMALL), jscene.Light(*LIGHT))
    assert got.shape == (80, 80, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(want))


def test_factor_one_is_the_deferred_frame():
    s = small_scene()
    got = supersample.SupersampledRenderer(SMALL, 1).render_numpy(
        s, scene.Light(*LIGHT), device="cpu")
    want = DeferredRenderer(SMALL).configure_for(s).render_numpy(
        s, scene.Light(*LIGHT), device="cpu")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        supersample.SupersampledRenderer(SMALL, 0)


def test_box_filter_is_the_mean_of_each_block():
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (12, 15, 3)).astype(np.uint8)
    got = supersample.box_filter(torch.from_numpy(frame), 3)
    want = frame.astype(np.float32).reshape(4, 3, 5, 3, 3).mean(axis=(1, 3))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_unfiltered_frame_matches_cpp():
    """The s = 2 frame before the box filter is the oracle's frame of the
    scaled scene under the scaled light."""
    ss = supersample.SupersampledRenderer(SMALL, 2)
    base = small_scene()
    ds = ss.prepare(base, device="cpu")
    light = np.asarray(LIGHT, np.int32) * 2
    frame = ss.renderer.render(ds, light).numpy()
    golden, _ = native.cpp_render_frame(supersample.scale_scene(base, 2),
                                        scene.Light(*map(int, light)),
                                        ss.config)
    assert frame.shape == (160, 160, 3)
    np.testing.assert_array_equal(frame, golden)
    np.testing.assert_array_equal(
        supersample.box_filter(torch.from_numpy(golden), 2).numpy(),
        ss.render(ds, LIGHT).numpy())


@pytest.mark.parametrize("fuse", [False, True])
def test_batched_sweep_matches_cpp(fuse):
    """A light sweep of F = 4 at s = 2 through ``render_states`` with a
    ``StaticBins`` cache, as the config-5 bench drives it, on both paths:
    each frame is the oracle's."""
    ss = supersample.SupersampledRenderer(SMALL, 2)
    base = small_scene()
    ds = ss.prepare(base, device="cpu")
    scaled = supersample.scale_scene(base, 2)
    ss.renderer.fuse_trace_shadow = fuse
    anim = AnimationRenderer(ss.renderer, ss.config, static_bins=StaticBins(
        scaled.pos, scaled.ext, 1, ss.config, ss.renderer.spans,
        device="cpu"))
    players, lights = anim.light_sweep_states(
        4, ds.pos[0], center=(120, 120, 40), radius=40, device="cpu")
    frames = anim.render_states(ds, players, lights).numpy()
    assert frames.shape == (4, 160, 160, 3)
    for f in range(4):
        golden, _ = native.cpp_render_frame(
            scaled, scene.Light(*map(int, lights[f])), ss.config)
        np.testing.assert_array_equal(frames[f], golden, err_msg=str(f))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("s", [2, 4])
def test_cuda_render_matches_cpu(cuda, s, fuse):
    """On the card the 80- and 160-pixel tiles are walked in bands: the
    box-filtered frame (light given as a tensor on the card) equals the
    CPU's plain versions'."""
    ss = supersample.SupersampledRenderer(SMALL, s)
    ss.renderer.fuse_trace_shadow = fuse
    base = small_scene()
    want = ss.render_numpy(base, scene.Light(*LIGHT), device="cpu")
    ds = ss.prepare(base, device=cuda)
    got = ss.render(ds, torch.tensor(LIGHT, device=cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
