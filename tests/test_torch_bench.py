"""The port's run entry points (``bench``, ``bench_scale``, ``make_demo``)
against the JAX package's (root ``bench.py``, ``tools/bench_scale.py``,
``tools/make_demo.py``) and the C++ oracle, on the CPU.

The tolerance is exact: light sweeps, scenes and checksums equal value for
value, frames pixel for pixel, files byte for byte.  The timing arithmetic
is checked on fixed timings.  Each entry point refuses to run without a
card: a CPU run says nothing about it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu import assets as jassets
from pixel_art_raytracer_tpu import config as jconfig
from pixel_art_raytracer_tpu import scene as jscene
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.models import supersample as jsupersample
from pixel_art_raytracer_tpu_torch import bench, bench_scale, device
from pixel_art_raytracer_tpu_torch import make_demo
from pixel_art_raytracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import DeferredRenderer
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer, scale_scene)
from pixel_art_raytracer_tpu_torch.runtime import native
from pixel_art_raytracer_tpu_torch.scene import Light, SceneBuilder

REPO = make_demo.DOCS.parent
SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
JSMALL = jconfig.RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(atlas=None, sprites=1):
    """``tests/test_extensions.small_scene``; box i of the 3 x 3 floor
    takes sprite i mod ``sprites`` of ``atlas``."""
    b = SceneBuilder(config=SMALL, atlas=atlas)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16),
                     sprite_id=(3 * i + j) % sprites)
    return b.build()


@pytest.mark.parametrize("entry", ["bench", "bench_scale", "make_demo",
                                   "card"])
def test_entry_points_refuse_without_a_card(entry, monkeypatch, tmp_path):
    """Each entry point measures or renders on the card, or does nothing:
    no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"bench": lambda: bench.main([]),
            "bench_scale": lambda: bench_scale.main([]),
            "make_demo": lambda: make_demo.main(tmp_path / "out"),
            "card": device.card}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("frames", [64, 256])
def test_sweeps_match_the_jax_bench(frames):
    """``bench.py:196-205``: radius 40 around the default light, (20, y,
    z) and (x, y, 280), the player fixed."""
    player = np.array([240, 36, 80], np.int32)  # graybox's entity 0
    anim = AnimationRenderer(DeferredRenderer(DEFAULT_CONFIG),
                             DEFAULT_CONFIG)
    got = bench.sweeps(anim, player, frames, "cpu")
    light = jscene.default_light(jconfig.DEFAULT_CONFIG)
    centers = {"center": (light.x, light.y, light.z),
               "edge_x": (20, light.y, light.z),
               "edge_z": (light.x, light.y, 280)}
    janim = janimation.AnimationRenderer(
        jdeferred.DeferredRenderer(jconfig.DEFAULT_CONFIG),
        jconfig.DEFAULT_CONFIG)
    assert list(got) == list(centers)
    for name, c in centers.items():
        jp, jl = janim.light_sweep_states(frames, player, center=c,
                                          radius=40)
        players, lights = got[name]
        assert players.dtype == lights.dtype == torch.int32
        assert lights.shape == (frames, 3)
        np.testing.assert_array_equal(players.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(lights.numpy(), np.asarray(jl))


@pytest.mark.parametrize("loadavg, cpus, runs, want", [
    (2.0, 2, (), False),           # the floor of 2 holds on few cores
    (2.01, 2, (), True),
    (3.9, 8, (), False),           # half the cores
    (4.01, 8, (), True),
    (0.0, None, (), False),        # unknown core count: 2 assumed
    (2.5, None, (), True),
    (0.5, 8, (7.5, 9.9, 10.0), False),  # worst 0.75 of the best
    (0.5, 8, (7.49, 9.9, 10.0), True),
])
def test_contended(loadavg, cpus, runs, want):
    assert bench.contended(loadavg, cpus, runs) is want


def test_summary_keys_and_arithmetic():
    ms = {"two_kernel": {"center": [10.0, 8.0], "edge_x": [20.0, 30.0],
                         "edge_z": [12.0, 16.0]},
          "fused": {"center": [6.0, 9.0], "edge_x": [5.0, 5.5],
                    "edge_z": [40.0, 4.0]}}
    single = {p: {o: [2 * t for t in v] for o, v in d.items()}
              for p, d in ms.items()}
    cfg = RenderConfig(view_width=100, view_height=50, view_length=50)
    tally = bench.launch_tally()
    s = bench.summarize(ms, single, cfg, 7, 4, 16, 3.0, {"contended": False},
                        {"two_kernel": True, "fused": False}, tally, "cpu")
    assert list(s) == [
        "metric", "value", "unit", "vs_baseline", "worst_orbit",
        "per_orbit", "single_batch_median", "single_batch_per_orbit",
        "frames", "baseline_cpp_mrays", "baseline_conditions", "parity",
        "fused", "ms_per_frame", "runs", "launches", "device"]
    rays = 2 * 100 * 50 * 4  # 40,000 a batch: 40,000 / ms / 1e3 Mrays/s
    # Best runs 8, 20, 12 ms -> 5.0, 2.0, 3.33 Mrays/s; the median orbit is
    # the middle of (2.0, 3.33, 5.0).
    assert s["per_orbit"] == {"center": 5.0, "edge_x": 2.0, "edge_z": 3.33}
    assert s["value"] == 3.33 and s["worst_orbit"] == 2.0
    assert s["vs_baseline"] == round(rays / 12.0 / 1e3 / 3.0, 2) == 1.11
    assert s["single_batch_per_orbit"] == {"center": 2.5, "edge_x": 1.0,
                                           "edge_z": 1.67}
    assert s["single_batch_median"] == 1.67
    assert s["ms_per_frame"] == {"center": 2.0, "edge_x": 5.0,
                                 "edge_z": 3.0}
    assert s["runs"]["two_kernel"]["edge_x"] == [2.0, 1.33]
    assert s["fused"]["per_orbit"] == {"center": 6.67, "edge_x": 8.0,
                                       "edge_z": 10.0}
    assert s["fused"]["value"] == 8.0 and s["fused"]["vs_baseline"] == 2.67
    assert s["fused"]["parity"] is False and s["parity"] is True
    assert s["frames"] == 4 and s["unit"] == "Mrays/s"
    assert s["baseline_cpp_mrays"] == 3.0
    assert "100x50, 7 boxes" in s["metric"] and "16 back-to-back" in s[
        "metric"]


def test_median_of_is_the_jax_bench_median():
    assert bench.median_of({"a": 3.0, "b": 1.0, "c": 2.0}) == 2.0
    assert bench.median_of({"a": 4.0, "b": 1.0}) == 4.0


def jax_checksums(scene, states):
    """The JAX batched path's per-frame int32 checksums of ``states``."""
    jr = jdeferred.DeferredRenderer(JSMALL, shadow_max_steps=32,
                                    trace_impl="jnp", shadow_impl="scan")
    jr.spans = jr.spans_for(scene)
    janim = janimation.AnimationRenderer(jr, JSMALL)
    jds = jdeferred.DeviceScene.from_scene(scene, JSMALL)
    out = {}
    for name, (players, lights) in states.items():
        frames = janim.render_states(jds, jnp.asarray(players.numpy()),
                                     jnp.asarray(lights.numpy()))
        out[name] = np.asarray(frames.reshape(frames.shape[0], -1).sum(
            axis=1, dtype=jnp.int32))
    return out


def test_run_on_the_cpu_has_parity_and_the_jax_checksums():
    scene = small_scene()
    result = bench.run("cpu", scene, SMALL, frames=4, repeats=1, bursts=2,
                       settle_s=0)
    s = result.summary
    assert s["parity"] is True and s["fused"]["parity"] is True
    assert result.differing == {"two_kernel": 0, "fused": 0}
    assert s["device"] == "cpu" and s["frames"] == 4
    assert s["baseline_cpp_mrays"] > 0 and s["value"] > 0
    # A warm-up pass and one timed pass, 3 orbits, a burst and a batch each.
    assert s["launches"]["two_kernel"]["batches"] == 2 * 3 * (2 + 1)
    assert set(s["runs"]["fused"]) == {"center", "edge_x", "edge_z"}
    anim = AnimationRenderer(DeferredRenderer(SMALL), SMALL)
    want = jax_checksums(scene, bench.sweeps(anim, scene.pos[0], 4, "cpu"))
    for path in bench.PATHS:
        for name, cs in want.items():
            assert result.checksums[path][name].dtype == np.int32
            np.testing.assert_array_equal(result.checksums[path][name], cs,
                                          err_msg=f"{path} {name}")


def jax_config5_scene(nonramp):
    """``tools/bench_scale.py:36-68`` with the JAX package."""
    cfg = jconfig.RenderConfig(view_width=1024, view_height=1024,
                               view_length=320)
    atlas = None
    if nonramp:
        tile = jassets.make_tile_floor()
        h, w = tile.depth.shape[-2:]
        r_ = np.arange(h)[:, None]
        c_ = np.arange(w)[None, :]
        depth1 = (np.maximum(0, 19 - r_)
                  + np.where(c_ >= w // 2, 3, 0)).astype(np.int32)
        atlas = jassets.SpriteAtlas(
            color=np.stack([tile.color[0], tile.color[0]]),
            depth=np.stack([tile.depth[0], depth1]),
            normal=np.stack([tile.normal[0], tile.normal[0]]))
    b = jscene.SceneBuilder(config=cfg, atlas=atlas)
    b.insert((500, 36, 80), (20, 20, 20))
    n = 1
    i = 0
    while n < 10_000:
        x = (i * 37) % 1040
        z = (i * 53) % 300
        y = 20 if (i % 7 == 0) else 0
        b.insert((x, y, z), (20, 20, 20),
                 sprite_id=(i % 2) if nonramp else 0)
        n += 1
        i += 1
    return b.build()


@pytest.mark.parametrize("nonramp", [False, True])
def test_config5_scene_matches_the_jax_bench_scale(nonramp):
    got = bench_scale.config5_scene(nonramp)
    want = jax_config5_scene(nonramp)
    assert got.n_entities == 10_000
    for field in ("pos", "ext", "sprite_id"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("color", "depth", "normal"):
        g = getattr(got.atlas, field)
        w = np.asarray(getattr(want.atlas, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.atlas.depth_is_row_only is not nonramp
    assert dataclasses.asdict(bench_scale.CONFIG) == dataclasses.asdict(
        jconfig.RenderConfig(view_width=1024, view_height=1024,
                             view_length=320))


def test_nonramp_supersampled_frame_matches_jax_and_cpp():
    """The non-ramp atlas (two column bands) on a small scene: the port's
    box-filtered frame equals the JAX ``SupersampledRenderer``'s, and the
    unfiltered frame the oracle's of the scaled scene."""
    scene = small_scene(bench_scale.nonramp_atlas(), sprites=2)
    light, s = (60, 60, 20), 2
    ss = SupersampledRenderer(SMALL, s)
    got = ss.render_numpy(scene, Light(*light), device="cpu")
    jatlas = jassets.SpriteAtlas(color=scene.atlas.color,
                                 depth=scene.atlas.depth,
                                 normal=scene.atlas.normal)
    jscene_ = jscene.Scene(pos=scene.pos, ext=scene.ext,
                           sprite_id=scene.sprite_id, atlas=jatlas)
    want = jsupersample.SupersampledRenderer(JSMALL, s).render_numpy(
        jscene_, jscene.Light(*light))
    np.testing.assert_array_equal(got, np.asarray(want))
    ds = ss.prepare(scene, device="cpu")
    scaled_light = np.asarray(light, np.int32) * s
    frame = ss.renderer.render(ds, scaled_light).numpy()
    golden, _ = native.cpp_render_frame(scale_scene(scene, s),
                                        Light(*map(int, scaled_light)),
                                        ss.config)
    np.testing.assert_array_equal(frame, golden)


def test_bench_scale_run_on_the_cpu_has_parity():
    """``bench_scale.run`` on a small non-ramp scene at s = 2: both paths'
    frame 0 equal the oracle's, ``render`` its box filter."""
    scene = small_scene(bench_scale.nonramp_atlas(), sprites=2)
    result = bench_scale.run("cpu", scene, factor=2, iters=1, frames=2,
                             config=SMALL, light=(40, 50, 20))
    s = result.summary
    assert result.differing == {"two_kernel": 0, "fused": 0, "render": 0}
    assert s["parity"] is True and s["fused"]["parity"] is True
    assert s["side"] == 160 and s["rays_per_frame"] == 2 * 160 * 160
    assert s["depth_varies_along_rows"] is True
    assert s["launches"]["fused"]["batches"] == 2
    assert s["device"] == "cpu" and s["peak_gib"] is None
    np.testing.assert_array_equal(result.lights[0].numpy(),
                                  [(40 + 40) * 2, 100, 40])


def test_make_demo_frame_is_the_docs_png(tmp_path):
    """One frame of the sweep on the CPU: ``graybox_frame.png`` is
    ``docs/graybox_frame.png`` byte for byte."""
    encoder = make_demo.main(tmp_path, n_frames=1, device="cpu")
    assert encoder in ("native", "python")
    assert ((tmp_path / "graybox_frame.png").read_bytes()
            == (REPO / "docs" / "graybox_frame.png").read_bytes())
    assert (tmp_path / "graybox_sweep.gif").read_bytes()[:6] == b"GIF89a"


def test_make_demo_never_writes_into_docs():
    with pytest.raises(ValueError, match="JAX package"):
        make_demo.write_demo(REPO / "docs", np.zeros((1, 2, 2, 3), np.uint8))
