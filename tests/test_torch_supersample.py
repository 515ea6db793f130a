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


# -- batches at the base size: render_states and the box filter kernel -------

# A 64x48 base view, F = 3, a seeded scene of 60 boxes (the player first),
# against the benchmark's plain reference (port_bench/reference).
REF_CONFIG = {"view_width": 64, "view_height": 48, "view_length": 64,
              "bin_size": 40, "bin_capacity": 8, "sprite_width": 20,
              "sprite_height": 40, "ambient": 0.25,
              "background": [127, 127, 127, 0],
              "palette": [[100, 100, 100, 0], [140, 140, 140, 0],
                          [200, 200, 200, 0], [240, 240, 240, 0]],
              "early_exit": True}


def ref_cell(s: int):
    """``(config dict, scene arrays, players, lights)``: the states of 3
    frames in traced-world units, the player and the light moving."""
    from port_bench import inputs
    cfg = dict(REF_CONFIG, supersample=s)
    r = np.random.default_rng(60 + s)
    boxes = [((20, 10, 20), (20, 20, 20))] + [
        ((int(r.integers(-10, 64)), int(r.integers(0, 30)),
          int(r.integers(0, 60))),
         tuple(int(v) for v in r.integers(4, 21, 3))) for _ in range(59)]
    arrays = inputs.scene_arrays(boxes, cfg)
    players = np.stack([r.integers(0, 40, 3), r.integers(0, 30, 3),
                        r.integers(0, 40, 3)], 1) * s
    lights = np.stack([r.integers(-20, 90, 3), r.integers(10, 80, 3),
                       r.integers(-10, 70, 3)], 1) * s
    return cfg, arrays, players.astype(np.int32), lights.astype(np.int32)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("s", [2, 3])
def test_render_states_matches_the_plain_reference(s, cache):
    """F base-size frames: the batched path on the scaled scene and the
    filter, with and without a ``StaticBins`` cache, pixel for pixel the
    reference's box-filtered frames; frame by frame ``render_states`` at
    F = 1 and the per-frame filter of the traced batch."""
    from port_bench import harness, program, reference
    cfg, arrays, players, lights = ref_cell(s)
    ss = supersample.SupersampledRenderer(program.render_config(cfg), s)
    base = program.scene(arrays)
    ds = ss.prepare(base, device="cpu")
    scaled = supersample.scale_scene(base, s)
    bins = (StaticBins(scaled.pos, scaled.ext, 1, ss.config,
                       ss.renderer.spans, device="cpu") if cache else None)
    p, l = torch.from_numpy(players), torch.from_numpy(lights)
    got = ss.render_states(ds, p, l, bins)
    assert got.shape == (3, 48, 64, 3) and got.dtype == torch.uint8
    traced = harness.reference_frames(
        harness.reference_scene(arrays, cfg, torch.device("cpu")), players,
        lights, harness.view(cfg), torch.float32)
    want = torch.stack([reference.box_filter(f, s) for f in traced])
    assert torch.equal(got, want)
    assert (want != want[:1]).any()  # the frames differ from each other
    for f in range(3):
        one = ss.render_states(ds, p[f:f + 1], l[f:f + 1], bins)
        assert torch.equal(one[0], got[f])
        assert torch.equal(supersample.box_filter(traced[f], s), got[f])


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_batched_box_filter_equals_the_per_frame_one(s):
    frames = torch.from_numpy(np.random.default_rng(s).integers(
        0, 256, (3, 5 * s, 7 * s, 3)).astype(np.uint8))
    got = supersample.box_filter(frames, s)
    assert got.shape == (3, 5, 7, 3)
    for f in range(3):
        assert torch.equal(got[f], supersample.box_filter(frames[f], s))
    want = frames.numpy().astype(np.int64).reshape(3, 5, s, 7, s, 3).sum(
        axis=(2, 4)) // (s * s)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_truncated_float_quotient_is_the_integer_one(s):
    """Every sum of s * s bytes: the plain chain's truncated float32
    quotient by a float32 tensor is sum // (s * s), which the kernel
    computes."""
    sums = torch.arange(255 * s * s + 1, dtype=torch.int64)
    count = torch.tensor(float(s * s), dtype=torch.float32)
    got = torch.trunc(sums.to(torch.float32) / count).to(torch.int64)
    assert torch.equal(got, sums // (s * s))


@pytest.mark.parametrize("case", ["one axis", "five axes", "int16",
                                  "four channels", "factor 0",
                                  "factor 3 of 8x8", "cpu tensor"])
def test_filter_wrapper_refuses_what_it_does_not_take(case):
    """``filter_cuda.box_filter`` raises ``ValueError`` before any launch:
    for a tensor it does not take, a factor that does not divide the
    frame, and a tensor off the card (the CPU takes the plain chain)."""
    from pixel_art_raytracer_tpu_torch.ops import filter_cuda
    frames, s = {
        "one axis": (torch.zeros(48, dtype=torch.uint8), 2),
        "five axes": (torch.zeros(1, 1, 8, 8, 3, dtype=torch.uint8), 2),
        "int16": (torch.zeros(8, 8, 3, dtype=torch.int16), 2),
        "four channels": (torch.zeros(8, 8, 4, dtype=torch.uint8), 2),
        "factor 0": (torch.zeros(8, 8, 3, dtype=torch.uint8), 0),
        "factor 3 of 8x8": (torch.zeros(2, 8, 8, 3, dtype=torch.uint8), 3),
        "cpu tensor": (torch.zeros(2, 8, 8, 3, dtype=torch.uint8), 2),
    }[case]
    before = filter_cuda.filter_launches
    with pytest.raises(ValueError):
        filter_cuda.box_filter(frames, s)
    assert filter_cuda.filter_launches == before


def test_render_states_spans_the_filter_inside_its_batch():
    """One ``batch`` span a call, the filter in ``batch.filter`` inside
    it; a still also uploads its light in ``sync.upload``."""
    from port_bench import program
    cfg, arrays, players, lights = ref_cell(2)
    ss = supersample.SupersampledRenderer(program.render_config(cfg), 2)
    ds = ss.prepare(program.scene(arrays), device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ss.render_states(ds, torch.from_numpy(players[:1]),
                         torch.from_numpy(lights[:1]))
        ss.render(ds, lights[0] // 2)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name in ("batch", "batch.filter", "sync.upload")]
    names = [n for n, _, _ in spans]
    assert names.count("batch") == 2 and names.count("batch.filter") == 2
    batches = [(a, b) for n, a, b in spans if n == "batch"]
    outside = [n for n, a, b in spans
               if not any(a0 <= a and b <= b0 for a0, b0 in batches)]
    # The CPU's plain binning uploads inside the batch; the light outside.
    assert outside == ["sync.upload"]


@pytest.mark.cuda
@pytest.mark.parametrize("case,s", [
    *((c, s) for c in ("odd", "config5_f1") for s in (1, 2, 3, 4)),
    ("config5_f64", 2)])
def test_cuda_filter_kernel_is_bit_exact(cuda, case, s):
    """The kernel against the plain chain on the card: odd widths and
    heights from an unaligned start (F = 3), and config 5's 1024x1024
    base at F = 1 and, at its s = 2, F = 64 (805 MB traced)."""
    from pixel_art_raytracer_tpu_torch.ops import filter_cuda
    F, H, W = {"odd": (3, 23, 37), "config5_f64": (64, 1024, 1024),
               "config5_f1": (1, 1024, 1024)}[case]
    n = F * H * s * W * s * 3
    gen = torch.Generator(device=cuda).manual_seed(s)
    buf = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device=cuda,
                        generator=gen)
    start = 5 if case == "odd" else 0
    frames = buf[start:start + n].view(F, H * s, W * s, 3)
    before = filter_cuda.filter_launches
    got = supersample.box_filter(frames, s)
    assert filter_cuda.filter_launches == before + 1
    assert got.shape == (F, H, W, 3)
    assert torch.equal(got, supersample.plain_box_filter(frames, s))
    one = supersample.box_filter(frames[F - 1], s)
    assert filter_cuda.filter_launches == before + 2
    assert torch.equal(one, got[F - 1])


@pytest.mark.cuda
def test_cuda_render_states_filters_in_one_launch_with_no_host_wait(cuda):
    """A batch on a ``StaticBins`` cache syncs nowhere (every sync an
    error), launches the filter once and equals the CPU's frames; a
    still launches it once a request."""
    from pixel_art_raytracer_tpu_torch.ops import filter_cuda
    from port_bench import program
    cfg, arrays, players, lights = ref_cell(2)
    frames = {}
    for dev in ("cpu", cuda):
        ss = supersample.SupersampledRenderer(program.render_config(cfg), 2)
        base = program.scene(arrays)
        ds = ss.prepare(base, device=dev)
        scaled = supersample.scale_scene(base, 2)
        bins = StaticBins(scaled.pos, scaled.ext, 1, ss.config,
                          ss.renderer.spans, device=dev)
        p = torch.from_numpy(players).to(dev)
        l = torch.from_numpy(lights).to(dev)
        if dev == "cpu":
            frames[dev] = ss.render_states(ds, p, l, bins)
            still = ss.render(ds, lights[0] // 2)
            continue
        ss.render_states(ds, p, l, bins)  # builds and loads the kernels
        torch.cuda.synchronize()
        before = filter_cuda.filter_launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ss.render_states(ds, p, l, bins)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert filter_cuda.filter_launches == before + 1
        frames[dev] = got.cpu()
        for _ in range(2):
            one = ss.render(ds, lights[0] // 2)
        assert filter_cuda.filter_launches == before + 3
        assert torch.equal(one.cpu(), still)
    assert torch.equal(frames["cpu"], frames[cuda])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [62, 63])
def test_cuda_filter_takes_factors_whose_tile_fits_shared_memory(cuda, s):
    """62 is the largest factor whose tile fits the 48 KB of shared memory
    a block gets: it filters as the plain chain does; 63 is refused by the
    C entry (a CUDA error raised, no launch counted)."""
    from pixel_art_raytracer_tpu_torch.ops import filter_cuda
    gen = torch.Generator(device=cuda).manual_seed(s)
    frames = torch.randint(0, 256, (2 * s, 3 * s, 3), dtype=torch.uint8,
                           device=cuda, generator=gen)
    before = filter_cuda.filter_launches
    if s == 63:
        with pytest.raises(RuntimeError, match="par_box_filter"):
            supersample.box_filter(frames, s)
        assert filter_cuda.filter_launches == before
        return
    got = supersample.box_filter(frames, s)
    assert filter_cuda.filter_launches == before + 1
    assert torch.equal(got, supersample.plain_box_filter(frames, s))
